"""libjxl_tpu_torch/ops/ans_kernel.py and the device-entropy batch decode
(api/tpu_codec.decode_batch_entropy) against the JAX package on the CPU.

The port's rANS decode is held to the NumPy lockstep simulator
(ops/ans_tpu.simulate) and to the JAX kernel in interpret mode, word for
word; its placement to the host qimg and to the JAX placement, exactly;
its images to the port's host-entropy batch exactly and to the JAX path
and the host decode within one u8 step. On the CPU, kernels.ans_decode
runs the plain twin, ans_decode_plain; tests/test_torch_cuda.py holds the
CUDA kernel to it on a card.
"""

import copy
import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from libjxl_tpu.api import codestream
from libjxl_tpu.api.tpu_codec import decode_tpu_batch_entropy
from libjxl_tpu.ops import ans_kernel as jak
from libjxl_tpu.ops import ans_tpu
from libjxl_tpu_torch.api import tpu_codec
from libjxl_tpu_torch.base.status import JXLError
from libjxl_tpu_torch.ops import ans_tpu as tans
from libjxl_tpu_torch.ops import ans_kernel as tak
from libjxl_tpu_torch.ops import kernels
from tests.test_ans_kernel import _decode_state, _image, _plan_for


@pytest.fixture(scope="module")
def case():
    """tests/test_ans_kernel.py's two 512^2 d4 streams (8 lanes), their
    plan, the simulator's result and the port's decode of it."""
    datas = [codestream.encode_lossy(_image(512, s), distance=4.0,
                                     effort=3) for s in (7, 8)]
    plan = _plan_for(datas)
    lp = tak.build_lane_plan(plan)
    n = kernels.ANS_DECODE_LAUNCHES.count
    tape, ok, steps = kernels.ans_decode(lp.to("cpu"))
    assert kernels.ANS_DECODE_LAUNCHES.count == n  # the twin launches none
    return types.SimpleNamespace(
        datas=datas, plan=plan, lp=lp, tape=tape, ok=ok, steps=steps,
        sim=ans_tpu.simulate(plan))


@pytest.fixture(scope="module")
def jax_decode(case):
    """The JAX kernel's tape (interpret mode) as [T, L], its ok flags and
    its ServePlan."""
    tape_s, steps_s, _ = case.sim
    sp = jak.build_serve_plan(case.plan)
    tape, _, ok, _ = jak.decode_device(
        sp, interpret=True, max_steps_hint=steps_s + jak.F_TOT)
    L = case.plan.n_lanes
    return types.SimpleNamespace(
        sp=sp, tape_dev=tape,
        tape=np.asarray(tape).reshape(-1, 1024)[:, :L],
        ok=np.asarray(ok).reshape(-1)[:L])


def test_twin_tape_matches_simulator(case):
    tape_s, steps_s, ok_s = case.sim
    tape = case.tape.numpy()
    assert tape.shape == (case.plan.max_steps, case.plan.n_lanes)
    assert ok_s.all() and case.ok.all()
    np.testing.assert_array_equal(tape[:steps_s], tape_s)
    assert (tape[steps_s:] == 0).all()
    assert int(case.steps.max()) == steps_s
    # a lane's steps end at its last nonzero tape row
    for lane, s in enumerate(case.steps.tolist()):
        assert tape[s - 1, lane] != 0 and (tape[s:, lane] == 0).all()


def test_program_plan_pads_and_decodes_alike(case):
    """program_plan's padding (flat_hw to a power of two halfwords, the
    alias tables to ALIAS_STEP rows, the tape to TAPE_STEP rows) changes
    no decoded token, flag or step count."""
    lp, pp = case.lp, tak.program_plan(case.lp)
    n = len(pp.flat_hw)
    assert n & (n - 1) == 0 and n >= len(lp.flat_hw)
    assert pp.alias_rows % tak.ALIAS_STEP == 0
    assert pp.alias_rows >= lp.alias_rows
    assert pp.a1.shape == pp.a2.shape == (lp.B, pp.alias_rows * 128)
    assert pp.t_alloc == tak.tape_rows(lp.t_alloc)
    tape, ok, steps = kernels.ans_decode(pp.to("cpu"))
    assert torch.equal(ok, case.ok) and torch.equal(steps, case.steps)
    assert torch.equal(tape[:len(case.tape)], case.tape)
    assert not tape[len(case.tape):].any()


def test_twin_tape_matches_jax_kernel(case, jax_decode):
    tape = case.tape.numpy()
    T = jax_decode.tape.shape[0]
    assert T <= tape.shape[0]
    np.testing.assert_array_equal(tape[:T], jax_decode.tape)
    assert (tape[T:] == 0).all()
    np.testing.assert_array_equal(case.ok.numpy(), jax_decode.ok)


def test_lane_plan_carries_across_from_serve_plan(case):
    lp = case.lp
    got = tak.lane_plan_from_serve_plan(jak.build_serve_plan(case.plan))
    assert lp.n_lanes == got.n_lanes == 8
    for f in dataclasses.fields(tak.LanePlan):
        a, b = getattr(lp, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_place_matches_host_qimg_and_jax(case, jax_decode):
    q = tak.place(case.tape[:int(case.steps.max())], case.lp)
    assert q.dtype == torch.int32 and q.shape == (2, 3, 512, 512)
    # the full tape, zero rows and all, places the same
    assert torch.equal(q, tak.place(case.tape, case.lp))
    jq = np.asarray(jak.place_device(jax_decode.sp, jax_decode.tape_dev))
    np.testing.assert_array_equal(q.numpy(), jq)
    for si, data in enumerate(case.datas):
        ref = _decode_state(data, ac_raw=False).qimg
        np.testing.assert_array_equal(q[si].numpy(), ref)


def _max_step(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_decode_batch_entropy_matches_host_batch_and_jax(case):
    imgs, info = tpu_codec.decode_batch_entropy(case.datas, "cpu")
    assert info == {"path": "device_entropy"}
    jax_imgs, jinfo = decode_tpu_batch_entropy(case.datas)
    assert jinfo["path"] == "device_entropy"
    for img, base, jimg, data in zip(
            imgs, tpu_codec.decode_batch(case.datas, "cpu"), jax_imgs,
            case.datas):
        assert img.shape == (512, 512, 3) and img.dtype == np.uint8
        assert np.array_equal(img, base)
        assert _max_step(img, jimg) <= 1
        ref = codestream.decode(data, device=False)[0][:, :, :3]
        assert _max_step(img, ref) <= 1


def test_prepare_batch_entropy_stages_prepare_batch_arrays(case):
    config, render_args, lp = tpu_codec.prepare_batch_entropy(case.datas)
    bconfig, args = tpu_codec.prepare_batch(case.datas)
    assert config == bconfig
    assert len(render_args) == 9
    for a, b in zip(render_args, args[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lp.flat_hw, case.lp.flat_hw)


def test_out_of_scope_streams_fall_back(case):
    data = codestream.encode_lossy(_image(384, 3), distance=4.0, effort=3)
    with pytest.raises(tans.AnsTpuUnsupported, match="multiple of group"):
        tak.build_lane_plan(_plan_for([data]))
    imgs, info = tpu_codec.decode_batch_entropy([data], "cpu")
    assert info["path"] == "host_entropy"
    assert info["fallback"].startswith(
        "batch decode: device entropy unsupported:")
    assert np.array_equal(imgs[0], tpu_codec.decode_batch([data], "cpu")[0])
    # the JAX plan's lane grid holds 1024 lanes; the port says so
    wide = types.SimpleNamespace(max_bits_per_sym=21, states=case.plan.states,
                                 n_lanes=1025)
    with pytest.raises(tans.AnsTpuUnsupported, match="more than 1024"):
        tak.build_lane_plan(wide)


def test_corrupt_lane_flagged_like_simulator(case):
    plan = _plan_for(case.datas)
    lane = 5
    rng = np.random.default_rng(0)
    idx = rng.integers(0, plan.stream_nhw[lane], 4)
    plan.streams_hw[lane, idx] ^= rng.integers(1, 1 << 16, 4)
    _, _, ok_s = ans_tpu.simulate(plan)
    _, ok, _ = tak.ans_decode_plain(tak.build_lane_plan(plan).to("cpu"))
    np.testing.assert_array_equal(ok.numpy(), ok_s)
    assert ok.tolist() == [i != lane for i in range(8)]


def test_corrupt_stream_raises_naming_lanes(case):
    data = case.datas[0]
    offs, sizes = _decode_state(data, ac_raw=True).ac_raw[1][0]
    raw = bytearray(data)
    raw[offs[-1] + sizes[-1] // 2] ^= 0x5A
    bad = [bytes(raw), case.datas[1]]
    # lane 3, the stream's last AC group, is not ok: the device path
    # raises, and the host decoder rejects the stream too
    with pytest.raises(JXLError, match=r"^batch decode: device kernel "
                       r"flagged 1 lanes not ok: \[3\]$"):
        tpu_codec.decode_batch_entropy(bad, "cpu")
    with pytest.raises(JXLError, match="invalid AC stream"):
        tpu_codec.decode_batch(bad, "cpu")


def test_unfinished_lanes_raise(case, monkeypatch):
    build = tak.lane_plan_from_sections
    monkeypatch.setattr(
        tak, "lane_plan_from_sections",
        lambda *a: dataclasses.replace(build(*a), t_alloc=100))
    with pytest.raises(JXLError, match=r"^batch decode: device kernel "
                       r"flagged 8 lanes not ok: \[0, 1, 2, 3, 4, 5, 6, 7\]$"):
        tpu_codec.decode_batch_entropy(case.datas, "cpu")


# ---------------------------------------------- the card's lane-plan route


def _sections(datas):
    """The port's parsed states of `datas` with their AC section bytes and
    (offs, sizes), as prepare_batch_entropy hands them on."""
    states, _ = tpu_codec._parse(datas, ac_raw=True)
    return (states, [st.ac_raw[0] for st in states],
            [st.ac_raw[1][0] for st in states])


@pytest.fixture(scope="module")
def mixed_pair():
    """A d1 and a d4 stream: alias tables of different row counts, and AC
    sections of odd byte length."""
    return [codestream.encode_lossy(_image(512, s), distance=d, effort=3)
            for d, s in ((1.0, 7), (4.0, 8))]


@pytest.mark.parametrize("pair", ["case", "mixed_pair"])
def test_lane_plan_from_sections_matches_jax_plan_route(pair, case, request):
    """The card's route gives the LanePlan of the oracle route fed the JAX
    package's DecodePlan, field for field, and the same program key."""
    datas = case.datas if pair == "case" else request.getfixturevalue(pair)
    states, frames, raws = _sections(datas)
    if pair == "mixed_pair":
        packed, _, _ = tans.pack_tables(states)
        assert len({len(p[0]) // 128 for p in packed}) == 2
        assert any(int(n) % 2 for _, sizes in raws for n in sizes)
    got = tak.lane_plan_from_sections(states, frames, raws)
    want = tak.build_lane_plan(_plan_for(datas))
    for f in dataclasses.fields(tak.LanePlan):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.t_alloc == 64 * 3 * tak.GROUP_BLOCKS ** 2
    assert tak.program_key(tak.program_plan(got)) == \
        tak.program_key(tak.program_plan(want))


@pytest.mark.parametrize("pair", ["case", "mixed_pair"])
def test_alias_packing_matches_jax(pair, case, request):
    """The port's _pack_alias_tables finds max_nbits without a loop over
    the tokens; its words and counts are the JAX package's."""
    datas = case.datas if pair == "case" else request.getfixturevalue(pair)
    states, _, _ = _sections(datas)
    for st in states:
        code, cm = st.ac_code[0], st.ac_context_map[0]
        got = tans._pack_alias_tables(code, cm)
        want = ans_tpu._pack_alias_tables(code, cm)
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[2:] == want[2:]


@pytest.fixture(scope="module")
def off_group_stream():
    """A 384^2 stream: its frame is no whole number of 256^2 groups."""
    return codestream.encode_lossy(_image(384, 3), distance=4.0, effort=3)


@pytest.fixture(scope="module")
def e5_stream():
    """A 512^2 e5 stream, whose AC strategies merge blocks."""
    return codestream.encode_lossy(_image(512, 5), distance=1.0, effort=5)


def _wide(case):
    # 129 copies of the pair: 1032 lanes of 4 groups each
    states, frames, raws = _sections(case.datas)
    return states * 129, frames * 129, raws * 129


def _big_alias(case):
    # image 1's tables at log alpha size 11: n x 2048 entries
    states, frames, raws = _sections(case.datas)
    st = copy.copy(states[1])
    code = copy.copy(st.ac_code[0])
    code.log_alpha_size = 11
    st.ac_code = [code, *st.ac_code[1:]]
    return [states[0], st], frames, raws


# name: (a stream fixture, or what makes the inputs from the case; the
# oracle's message, None where the test only holds the two routes equal)
OUT_OF_SCOPE = {
    "off_group": ("off_group_stream", "image dims not multiple of group"),
    "merged_blocks": ("e5_stream", None),
    "wide": (_wide, "more than 1024 lanes"),
    "big_alias": (_big_alias,
                  r"alias table too large for kernel \(\d+x2048\)"),
}


@pytest.mark.parametrize("name", list(OUT_OF_SCOPE))
def test_lane_plan_from_sections_refuses_like_oracle(name, case, request):
    """Outside the kernel's scope the card's route raises the oracle
    route's first message, and for a stream decode_batch_entropy gives the
    same fallback reason."""
    source, match = OUT_OF_SCOPE[name]
    stream = None
    if isinstance(source, str):
        stream = [request.getfixturevalue(source)]
        states, frames, raws = _sections(stream)
    else:
        states, frames, raws = source(case)
    if name == "merged_blocks":
        assert any((st.strategy != 0).any() for st in states)
    with pytest.raises(tans.AnsTpuUnsupported) as want:
        tak.build_lane_plan(
            tans.build_plan(states, frames, raws, shared_tables=False))
    msg = str(want.value)
    if match is not None:
        assert re.fullmatch(match, msg)
    with pytest.raises(tans.AnsTpuUnsupported) as got:
        tak.lane_plan_from_sections(states, frames, raws)
    assert str(got.value) == msg
    if stream is None:
        return
    with pytest.raises(tans.AnsTpuUnsupported) as jax_route:
        tak.build_lane_plan(_plan_for(stream))
    assert str(jax_route.value) == msg
    reason = f"batch decode: device entropy unsupported: {msg}"
    if name == "off_group":
        assert tpu_codec.decode_batch_entropy(stream, "cpu")[1] == {
            "path": "host_entropy", "fallback": reason}
    else:
        # the host batch refuses merged blocks too, and notes the reason
        with pytest.raises(JXLError, match="non-DCT8") as host:
            tpu_codec.decode_batch_entropy(stream, "cpu")
        assert f"device-entropy fallback: {reason}" in host.value.__notes__


def _code(las, rights, cfgs):
    """A stand-in AC code: one alias table a row of `rights` (its other
    fields counting up), hybrid-uint configs (split_exponent,
    msb_in_token, lsb_in_token)."""
    size = 1 << las
    tables = [types.SimpleNamespace(
        cutoff=np.arange(size) % 7, right_value=np.asarray(r),
        freq0=np.arange(size) * 3, offsets1=np.arange(size) * 5,
        freq1=np.arange(size) * 11) for r in rights]
    return types.SimpleNamespace(
        alias_tables=tables, log_alpha_size=las,
        uint_config=[types.SimpleNamespace(
            split_exponent=s, msb_in_token=m, lsb_in_token=b)
            for s, m, b in cfgs])


ALIAS_CODES = {
    # tokens up to 31 and 63 past the splits, every config's raw bits
    "in_scope": (5, [np.arange(32) % 31, np.full(32, 63)],
                 [(4, 1, 0), (2, 0, 2)]),
    "small_tables": (4, [np.zeros(16, int)] * 3,
                     [(7, 3, 3), (0, 0, 0), (1, 1, 0)]),
    "alphabet": (5, [np.arange(32), np.full(32, 64)], [(4, 1, 0)] * 2),
    # table 0 trips the config before table 1 the alphabet
    "config_first": (5, [np.arange(32), np.full(32, 64)],
                     [(8, 1, 0), (4, 1, 0)]),
    "las": (3, [np.arange(8)] * 2, [(4, 1, 0)] * 2),
}


@pytest.mark.parametrize("name", list(ALIAS_CODES))
def test_alias_packing_refuses_and_counts_like_jax(name):
    """On stand-in tables, the port's _pack_alias_tables raises the JAX
    package's first message, or gives its words and max_nbits."""
    code = _code(*ALIAS_CODES[name])
    try:
        want = ans_tpu._pack_alias_tables(code, None)
    except ans_tpu.AnsTpuUnsupported as e:
        with pytest.raises(tans.AnsTpuUnsupported) as got:
            tans._pack_alias_tables(code, None)
        assert str(got.value) == str(e)
        assert name != "in_scope"
        return
    got = tans._pack_alias_tables(code, None)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:]
    assert name in ("in_scope", "small_tables") and want[3] > 0
