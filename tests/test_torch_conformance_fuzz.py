"""The port's conformance runner and fuzz harness
(libjxl_tpu_torch/tools/{conformance,fuzz}.py) against the JAX package's,
on seeded inputs at most 256x256.

Tolerances (ROADMAP.md, "How checked against works"): on the host
(device=None) the port writes the JAX runner's case files byte for byte
and prints what it prints; the kernels' plain twins (device="cpu") decode
within the runner's own bounds of the references (rmse 0.004, peak 0.02).
The fuzz harness finds nothing on either route, and counts any exception
but JXLError, a device error included, as a finding. The JAX tools run on
CPU-JAX, where their accelerator probe picks the host routes.
"""

import contextlib
import filecmp
import io
import json

import numpy as np
import pytest
import torch

from libjxl_tpu.tools import conformance as jconf
from libjxl_tpu.tools import fuzz as jfuzz
from libjxl_tpu_torch.api import codestream as tcs
from libjxl_tpu_torch.base.status import JXLError
from libjxl_tpu_torch.extras.io import save_image
from libjxl_tpu_torch.tools import conformance as tconf
from libjxl_tpu_torch.tools import fuzz as tfuzz

DEVICES = [None, "cpu"]
CASE_FILES = ("input.jxl", "ref.npy", "test.json")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The twins' torch ops on one thread: tier-1 runs six test processes
    on the machine's cores (the fuzz encode target runs the e5 tile costs
    of up to 100 tiny images)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_card():
    """Decided in the test, not at import: the tests that check the error
    the default device raises need a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("checks the error raised without a card")


def _noise(h, w, seed):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, 40, (h, w, 3)), 0, 255).astype(np.uint8)


def run(tool, argv):
    """(exit code, standard output) of tool.main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main([str(a) for a in argv])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def jax_corpus(tmp_path_factory):
    """A corpus made by the JAX runner: a lossy case (48x56, d1, two
    frames' worth of bounds) and a lossless one (tests/
    test_conformance_fuzz.py's images)."""
    d = tmp_path_factory.mktemp("jcorpus")
    jconf.generate_case(_noise(48, 56, 0), str(d / "lossy"), distance=1.0)
    rng = np.random.default_rng(1)
    jconf.generate_case(rng.integers(0, 256, (32, 40, 3)).astype(np.uint8),
                        str(d / "lossless"), lossless=True)
    return d


# ------------------------------------------------------------ conformance
@pytest.mark.parametrize("device", DEVICES, ids=["host", "cpu"])
@pytest.mark.parametrize("case", ["lossy", "lossless"])
def test_the_jax_corpus_passes_the_ports_check(jax_corpus, case, device):
    assert tconf.check_case(str(jax_corpus / case), device=device) == []


@pytest.mark.parametrize("lossless", [False, True],
                         ids=["lossy", "lossless"])
def test_generate_case_on_the_host_writes_the_jax_runners_files(
        tmp_path, lossless):
    img = _noise(48, 56, 2) if not lossless else \
        np.random.default_rng(3).integers(0, 256, (32, 40, 3)).astype(
            np.uint8)
    jconf.generate_case(img, str(tmp_path / "j"), lossless=lossless)
    tconf.generate_case(img, str(tmp_path / "t"), lossless=lossless,
                        device=None)
    for name in CASE_FILES:
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name,
                           shallow=False), name


def test_generate_case_on_the_twins_holds_to_the_host_decode(tmp_path):
    """A case made on the twins (encode and reference decode) passes the
    host check and the twins' check, and its reference is the host
    decode's within the runner's bounds."""
    case = tmp_path / "cpu"
    tconf.generate_case(_noise(48, 56, 4), str(case), effort=5,
                        device="cpu")
    assert json.loads((case / "test.json").read_text()) == {
        "rmse_limit": 0.004, "peak_error": 0.02}
    for device in DEVICES:
        assert tconf.check_case(str(case), device=device) == []
    host = tconf.decode_to_array(str(case / "input.jxl"), device=None)
    ref = np.load(case / "ref.npy")
    assert ref.shape == host.shape == (1, 48, 56, 3)
    assert np.abs(ref - host).max() <= 1 / 255 + 1e-7


@pytest.mark.parametrize("device", DEVICES, ids=["host", "cpu"])
def test_a_corrupted_reference_fails_in_the_port_too(tmp_path, device):
    """tests/test_conformance_fuzz.py:12-31, through the port."""
    case = tmp_path / "case1"
    tconf.generate_case(_noise(48, 56, 0), str(case), distance=1.0,
                        device=device)
    assert tconf.check_case(str(case), device=device) == []
    ref = np.load(case / "ref.npy")
    ref[..., 0] += 0.1
    np.save(case / "ref.npy", ref)
    failures = tconf.check_case(str(case), device=device)
    assert failures == jconf.check_case(str(case))
    assert failures and all("frame 0" in f for f in failures)


def test_the_cli_on_the_host_prints_what_the_jax_cli_prints(tmp_path):
    save_image(tmp_path / "a.ppm", _noise(40, 48, 5))
    save_image(tmp_path / "b.ppm", _noise(24, 32, 6))
    srcs = [tmp_path / "a.ppm", tmp_path / "b.ppm"]
    for extra in ([], ["--lossless"]):
        got = run(tconf, ["generate", *srcs, "--out", tmp_path / "t",
                          *extra, "--host"])
        assert got == run(jconf, ["generate", *srcs, "--out",
                                  tmp_path / "j", *extra])
        assert got[0] == 0
    for name in ("a", "b"):
        for f in CASE_FILES:
            assert filecmp.cmp(tmp_path / "t" / name / f,
                               tmp_path / "j" / name / f, shallow=False)
    got = run(tconf, ["check", tmp_path / "j", "-v", "--host"])
    assert got == run(jconf, ["check", tmp_path / "j", "-v"])
    assert got[0] == 0 and "2/2 cases pass" in got[1]
    assert run(tconf, ["check", tmp_path / "t", "--device", "cpu"]) == \
        (0, "a: OK\nb: OK\n2/2 cases pass\n")


def test_the_cli_asks_for_the_card_by_default(tmp_path, jax_corpus, no_card):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tconf.main(["check", str(jax_corpus)])
    save_image(tmp_path / "a.ppm", _noise(16, 16, 7))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tconf.main(["generate", str(tmp_path / "a.ppm"), "--out",
                    str(tmp_path / "c")])


# ------------------------------------------------------------------- fuzz
@pytest.mark.parametrize("device", DEVICES, ids=["host", "cpu"])
@pytest.mark.parametrize("target", sorted(jfuzz.TARGETS))
def test_fuzz_target_has_no_findings(target, device):
    """tests/test_conformance_fuzz.py:35's bounded pass, per target and
    route; every input is counted, none reaches a CUDA kernel here."""
    stats = {}
    assert tfuzz.run(target, iters=25, seed=1234, device=device,
                     stats=stats) == 0
    assert stats["inputs"] == 25 and stats["reached_kernel"] == 0
    assert 0 <= stats["rejected"] <= 25


def test_fuzz_targets_are_the_jax_harness_targets():
    assert list(tfuzz.TARGETS) == list(jfuzz.TARGETS)
    assert set(tfuzz.DEVICE_TARGETS) <= set(tfuzz.TARGETS)


def test_the_seed_corpus_on_the_host_is_the_jax_corpus():
    """The host encodes give the JAX harness's streams; the streaming
    stream (made on the twins under --host) decodes on the host within 1
    u8 step of the JAX one's decode."""
    got, want = tfuzz._seed_corpus(None), jfuzz._seed_corpus()
    assert len(got) == len(want) == 4
    assert got[:3] == want[:3]
    a = tcs.decode(got[3], device=None)[0].astype(int)
    b = tcs.decode(want[3], device=None)[0].astype(int)
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("exc", [RuntimeError("CUDA error: an illegal "
                                              "memory access"),
                                 ValueError("render_tail: 4x4 is below "
                                            "the halo 7"),
                                 torch.OutOfMemoryError("CUDA out of "
                                                        "memory")],
                         ids=["RuntimeError", "ValueError", "OutOfMemory"])
def test_a_device_error_is_a_finding(monkeypatch, exc, capsys):
    def failing_decode(data, **kw):
        raise exc

    monkeypatch.setattr(tcs, "decode", failing_decode)
    stats = {}
    assert tfuzz.run("decode", iters=6, seed=0, device="cpu",
                     stats=stats) == 6
    assert stats["rejected"] == 0
    assert type(exc).__name__ in capsys.readouterr().err


def test_a_clean_rejection_is_not_a_finding(monkeypatch):
    def rejecting_decode(data, **kw):
        raise JXLError("invalid AC stream")

    monkeypatch.setattr(tcs, "decode", rejecting_decode)
    stats = {}
    assert tfuzz.run("decode", iters=6, seed=0, device="cpu",
                     stats=stats) == 0
    assert stats["rejected"] == 6


def test_a_failing_seed_corpus_build_raises(monkeypatch):
    """The JAX harness swallows this and fuzzes random bytes only."""
    def failing_streaming(*a, **kw):
        raise RuntimeError("device step failed")

    monkeypatch.setattr(tcs, "encode_lossy_streaming", failing_streaming)
    with pytest.raises(RuntimeError, match="device step failed"):
        tfuzz.run("decode", iters=2, seed=0, device="cpu")
    assert jfuzz.run("decode", iters=2, seed=0) == 0


def test_the_fuzz_has_no_swallowed_exceptions():
    """The only broad handler left is the harness's own, in run."""
    import inspect

    src = inspect.getsource(tfuzz)
    assert src.count("except Exception") == 1
    assert "except Exception:\n            pass" not in src


def test_the_fuzz_cli_on_the_host_prints_what_the_jax_cli_prints():
    argv = ["--target", "fields", "--iters", "20", "--seed", "3"]
    got = run(tfuzz, [*argv, "--host"])
    assert got == run(jfuzz, argv) == (0, "fields: 20 iters, 0 findings\n")


def test_the_fuzz_asks_for_the_card_by_default(no_card):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfuzz.run("decode", iters=2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfuzz.fuzz_decode(b"\xff\x0a")
