"""Streaming / multi-host VarDCT encoding.

Mirrors EncodeFrameStreaming (enc_frame.cc:1975-2095): the image is
processed one 2048x2048 DC group at a time with bounded memory — per
DC group the pixel data is transformed, quantized and entropy-coded,
then dropped; only the finished section bytes, the (small) DC/metadata
token streams and per-DC-group histogram blobs are retained until final
assembly.

Departure from the reference's incremental histogram budgeting: each DC
group gets its own self-contained histogram *set* via the format's
`num_histograms` mechanism (dec_frame.cc:383-388 — each AC-group section
selects its set with ctx_offset bits). That makes DC groups fully
independent — the natural multi-host decomposition: every host encodes a
disjoint slice of DC groups and the coordinator concatenates
(sections, histogram blobs) — a host-level all-gather, matching
SURVEY.md 2.10's "global assembly = all-gather of byte blobs".

The per-DC-group pixel math (ops/pipeline: rgb_to_xyb,
gaborish_inverse, encode_step_xyb) runs as torch ops on the caller's
device; the hosts of the thread pool share it. With a `mesh`
(parallel/sharding.Mesh) the step runs with its rows sharded over the
mesh's devices (sharding.make_sharded_chunk_step) and writes the same
bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..entropy.encode import (
    _encode_uint_config,
    build_and_encode_histograms,
    encode_context_map,
    encode_histogram_counts,
    write_tokens,
)
from ..entropy.cluster import cluster_histograms
from ..entropy.encode import _estimate_token_cost
from ..entropy.alias import build_reverse_map, init_alias_table
from ..entropy.hybrid_uint import DEFAULT_UINT_CONFIG
from ..entropy.params import CLUSTERS_LIMIT
from ..io.bits import BitWriter
from ..io.frame_header import FrameHeader
from ..io.toc import write_group_offsets
from ..modular.codec import GroupHeader
from ..modular.predict import P_GRADIENT
from ..modular.tree import encode_tree, make_fixed_tree, num_tree_contexts
from ..ops import programs
from ..ops.staging import dequant_tables, f32
from . import ac_strategy as acs
from .ctx import QUANT_MAX
from .frame import (
    K_AC_QUANT,
    K_DC_QUANT,
    ORDER_ENC,
    VarDCTState,
    encode_cmap_dc_default,
    tokenize_ac_group,
    tokenize_dc_group,
)

STREAM_LOG_ALPHA = 8  # fixed so per-host alias tables agree


def _prep_program(rgb, gab):
    from ..ops import pipeline as pl
    from .heuristics import gaborish_inverse_kernel

    xyb0 = pl.rgb_to_xyb(rgb)
    xyb = pl.gaborish_inverse(
        xyb0, gaborish_inverse_kernel(1.0).astype(np.float32)) \
        if gab else xyb0
    return xyb0, xyb


def prep(rgb: np.ndarray, device, gab: bool = True):
    """A chunk's linear RGB f32[3, h, w] -> (pre-sharpening XYB,
    sharpened XYB) as numpy f32, computed on `device`: the adaptive-quant
    field is computed on pre-Gaborish values (enc_heuristics.cc:1105).
    The "chunk_prep" program (the JAX package's _jitted_chunk_step
    prep), its key the JAX one's static argument gab."""
    return programs.run("chunk_prep", (bool(gab),), _prep_program,
                        np.ascontiguousarray(rgb, dtype=np.float32),
                        gab=bool(gab), device=torch.device(device),
                        readback=True)


def _step_program(xyb, dm_inv, dm, qf_in, inv_global_scale, base_quant,
                  x_dm_mult, b_dm_mult):
    from ..ops import pipeline as pl

    return pl.encode_step_xyb(xyb, dm_inv, dm, inv_global_scale, base_quant,
                              x_dm_mult, b_dm_mult, qf_in=qf_in)


def step(xyb, dm_inv, dm, inv_global_scale, base_quant, x_dm_mult,
         b_dm_mult, qf_in, device):
    """ops/pipeline.encode_step_xyb of one DC group's XYB f32[3, h, w] on
    `device`, with the host's quant field qf_in; the scalars are f32
    values. Returns numpy (q, dc, qf, ytox, ytob, sharp). The
    "chunk_step" program (the JAX package's _jitted_chunk_step step,
    which has no static argument; the scalars, which its torch ops take
    by value, are in the program's key)."""
    return programs.run("chunk_step", (), _step_program, xyb, dm_inv, dm,
                        qf_in, float(inv_global_scale), float(base_quant),
                        float(x_dm_mult), float(b_dm_mult),
                        device=torch.device(device), readback=True)


class _EncodedDCGroup:
    """Per-DC-group result a host ships to the coordinator."""

    __slots__ = ("dc_group_id", "ac_sections", "dc_tokens", "meta_tokens",
                 "count", "histo_blob", "num_clusters", "context_map",
                 "group_ids")

    def __init__(self):
        self.ac_sections = {}  # group_id -> bytes


def _encode_dc_group(state: VarDCTState, fh: FrameHeader, dc_group_id: int,
                     get_chunk, dec_tree, wp_header, device,
                     sharded_step=None):
    """Compute (prep on `device`, the step there or through sharded_step,
    make_sharded_chunk_step's callable) + entropy-code (on the host) one
    DC group; returns _EncodedDCGroup."""
    fd = state.fd
    x0, y0, rw, rh = fd.dc_group_rect(dc_group_id)  # block units
    px0, py0 = x0 * 8, y0 * 8
    pw, ph = rw * 8, rh * 8
    margin = 8
    # fetch with margin for the inverse-Gaborish border, pad to DC-group
    # full size, every step one shape (enc_frame.cc:1489-1492)
    full = fd.dc_group_dim
    mx0 = max(0, px0 - margin)
    my0 = max(0, py0 - margin)
    mx1 = min(fd.xsize_padded, px0 + pw + margin)
    my1 = min(fd.ysize_padded, py0 + ph + margin)
    rgb = get_chunk(mx0, my0, mx1 - mx0, my1 - my0)
    rgb = np.asarray(rgb, dtype=np.float32)

    xyb_m0, xyb_m = prep(rgb, device, gab=bool(fh.loop_filter.gab))

    def crop_pad(arr):
        a = arr[:, py0 - my0:py0 - my0 + ph, px0 - mx0:px0 - mx0 + pw]
        pad_y, pad_x = full - ph, full - pw
        if pad_y or pad_x:
            a = np.pad(a, ((0, 0), (0, pad_y), (0, pad_x)), mode="edge")
        return a

    xyb = crop_pad(xyb_m)
    xyb_pre = crop_pad(xyb_m0)

    dm = dequant_tables(state)
    dm_inv = np.stack([state.matrices.inv_matrix(0, c)
                       for c in range(3)]).astype(np.float32)
    base_quant = max(1, min(QUANT_MAX, int(
        (K_AC_QUANT / state.nonserialized_distance)
        * state.quantizer.inv_global_scale + 0.5)))
    # per-chunk adaptive quantization field (the global scale is fixed
    # up-front from the uniform quant — streaming cannot see the whole
    # image's field median before emitting the header)
    from .heuristics import initial_quant_field_full

    nby_c, nbx_c = xyb.shape[1] // 8, xyb.shape[2] // 8
    qf_float = initial_quant_field_full(
        xyb_pre.astype(np.float64), nby_c, nbx_c,
        state.nonserialized_distance)
    qf_in = np.clip(qf_float * state.quantizer.inv_global_scale + 0.5,
                    1, QUANT_MAX).astype(np.int32)
    step_args = (xyb.astype(np.float32), dm_inv, dm,
                 f32(state.quantizer.inv_global_scale), f32(base_quant),
                 f32(state.x_dm_mult), f32(state.b_dm_mult), qf_in)
    qall, dc, qf, ytox_map, ytob_map, sharp = \
        sharded_step(*step_args) if sharded_step is not None \
        else step(*step_args, device)
    qall = qall[:, :rh, :rw]
    dc = dc[:, :rh, :rw]
    qf = qf[:rh, :rw]
    sharp = sharp[:rh, :rw]
    tby = -(-rh // 8)
    tbx = -(-rw // 8)
    ytox_map = ytox_map[:tby, :tbx]
    ytob_map = ytob_map[:tby, :tbx]

    # fill global state slices for this DC group
    state.raw_quant_field[y0:y0 + rh, x0:x0 + rw] = qf
    state.strategy[y0:y0 + rh, x0:x0 + rw] = acs.DCT
    state.is_origin[y0:y0 + rh, x0:x0 + rw] = True
    if fh.loop_filter.epf_iters > 0:
        state.epf_sharpness[y0:y0 + rh, x0:x0 + rw] = sharp
    state.dc[:, y0:y0 + rh, x0:x0 + rw] = dc
    ty0, tx0 = y0 // 8, x0 // 8
    state.ytox_map[ty0:ty0 + tby, tx0:tx0 + tbx] = ytox_map
    state.ytob_map[ty0:ty0 + tby, tx0:tx0 + tbx] = ytob_map

    out = _EncodedDCGroup()
    out.dc_group_id = dc_group_id
    out.dc_tokens, out.meta_tokens, out.count = tokenize_dc_group(
        state, dc_group_id, dec_tree, wp_header)

    # AC groups inside this DC group: tokenize, cluster, write sections
    coeffs_q = {}
    for by in range(rh):
        for bx in range(rw):
            coeffs_q[(y0 + by, x0 + bx)] = qall[:, by, bx].reshape(3, 64)
    gx0, gy0 = (x0 * 8) // fd.group_dim, (y0 * 8) // fd.group_dim
    gpd = fd.dc_group_dim // fd.group_dim  # groups per DC group side
    group_ids = []
    for gy in range(gy0, min(gy0 + gpd, fd.ysize_groups)):
        for gx in range(gx0, min(gx0 + gpd, fd.xsize_groups)):
            group_ids.append(gy * fd.xsize_groups + gx)
    out.group_ids = group_ids
    group_tokens = {g: tokenize_ac_group(state, g, coeffs_q)
                    for g in group_ids}

    num_ac = state.block_ctx_map.num_ac_contexts()
    histograms = _estimate_token_cost(list(group_tokens.values()), num_ac,
                                      DEFAULT_UINT_CONFIG)
    clustered, cmap = cluster_histograms(histograms, CLUSTERS_LIMIT)
    out.context_map = cmap
    out.num_clusters = len(clustered)
    # serialize histogram counts now (the decoder reconstructs these
    # exact tables), build matching alias tables for the section payloads
    blob = BitWriter()
    infos = []
    for h in clustered:
        counts, alpha = encode_histogram_counts(h, blob)
        table = init_alias_table(counts, STREAM_LOG_ALPHA)
        rev, freqs = build_reverse_map(table, alpha)
        infos.append((freqs, rev))
    out.histo_blob = blob

    class _Codes:
        pass

    codes = _Codes()
    codes.uint_config = [DEFAULT_UINT_CONFIG] * len(clustered)
    codes.encoding_info = infos
    codes.use_prefix_code = False
    from ..entropy.decode import LZ77Params

    codes.lz77 = LZ77Params()
    codes.lz77.set_default()
    histo_bits = (fd.num_dc_groups - 1).bit_length() \
        if fd.num_dc_groups > 1 else 0
    for g in group_ids:
        w = BitWriter()
        if histo_bits:
            w.write(histo_bits, dc_group_id)
        write_tokens(group_tokens[g], codes, cmap, w)
        out.ac_sections[g] = w.get_bytes()
    return out


def encode_vardct_frame_streaming(writer: BitWriter, get_chunk,
                                  fh: FrameHeader, distance: float = 1.0,
                                  hosts: int = 1, mesh=None,
                                  dc_distance: float = None,
                                  device="cuda") -> None:
    """Streaming DCT8 VarDCT encode with bounded per-host memory.

    get_chunk(px0, py0, w, h) -> (3, h, w) linear RGB float array
    (coordinates may extend to the padded frame size; the provider must
    edge-replicate). hosts > 1 processes disjoint DC-group slices on a
    thread pool — the multi-host decomposition demo (each thread stands
    in for one host; real deployment runs the same function per host
    with its chip and gathers the _EncodedDCGroup results over DCN).
    device: where each DC group's pixel math runs ("cuda" by default; a
    missing card raises; "cpu" runs the same torch ops on the CPU). mesh:
    a parallel/sharding.Mesh over which each DC group's step runs with its
    rows sharded (prep stays on `device`); the bytes are the same."""
    from ..base.device import resolve_device

    device = resolve_device(device)
    fd = fh.frame_dimensions()
    state = VarDCTState(fh, fd)
    # fixed 0.39/d global-scale anchor (enc_heuristics.cc:1115): the
    # streaming encoder must fix the scale before seeing any pixels
    from .frame import initial_quant_dc

    quant_dc = initial_quant_dc(dc_distance or distance)
    state.quantizer.compute_global_scale_and_quant(quant_dc,
                                                   0.39 / distance)
    state.nonserialized_distance = distance

    tree = make_fixed_tree(P_GRADIENT)
    tree_writer = BitWriter()
    dec_tree = encode_tree(tree, tree_writer)
    wp_header = GroupHeader().wp_header

    sharded_step = None
    if mesh is not None:
        from ..parallel.sharding import make_sharded_chunk_step

        sharded_step = make_sharded_chunk_step(mesh)

    def run(g):
        return _encode_dc_group(state, fh, g, get_chunk, dec_tree,
                                wp_header, device, sharded_step)

    if hosts > 1:
        from concurrent.futures import ThreadPoolExecutor

        # DC groups touch disjoint slices of the shared state arrays, so
        # host-parallel execution is safe (same property the reference
        # exploits with RunOnPool over DC groups, enc_frame.cc:1331)
        with ThreadPoolExecutor(max_workers=hosts) as pool:
            results = list(pool.map(run, range(fd.num_dc_groups)))
    else:
        results = [run(g) for g in range(fd.num_dc_groups)]

    # ---- coordinator: assemble the codestream (host all-gather analog)
    # modular histograms over all DC/meta token streams
    modular_token_lists = [[]]
    for res in results:
        modular_token_lists.append(res.dc_tokens)
        modular_token_lists.append(res.meta_tokens)
    histo_writer = BitWriter()
    codes, context_map = build_and_encode_histograms(
        modular_token_lists, num_tree_contexts(dec_tree), histo_writer)

    def write_dc_global(w):
        state.matrices.encode_dc(w)
        state.quantizer.encode(w)
        w.write(1, 1)  # default block ctx map
        encode_cmap_dc_default(w)
        w.write(1, 1)  # has global tree
        w.append_bits_from(tree_writer)
        w.append_bits_from(histo_writer)

    def write_dc_group(w, res):
        w.write(2, 0)  # extra_precision
        gh = GroupHeader()
        gh.use_global_tree = True
        gh.write(w)
        write_tokens(res.dc_tokens, codes, context_map, w)
        x0, y0, rw, rh = fd.dc_group_rect(res.dc_group_id)
        upper_bound = rw * rh
        nbits = (upper_bound - 1).bit_length() if upper_bound > 1 else 0
        if nbits:
            w.write(nbits, res.count - 1)
        gh2 = GroupHeader()
        gh2.use_global_tree = True
        gh2.write(w)
        write_tokens(res.meta_tokens, codes, context_map, w)

    def write_ac_global(w):
        from ..io.fields import u32_write

        state.matrices.encode(w, num_dc_groups=fd.num_dc_groups)
        nbits = (fd.num_groups - 1).bit_length() if fd.num_groups > 1 else 0
        if nbits:
            w.write(nbits, fd.num_dc_groups - 1)  # num_histograms - 1
        u32_write(ORDER_ENC, 0, w)  # default orders (like ref streaming)
        # one combined histogram structure: lz77 off, concatenated
        # context map (per-set cluster ids offset), uint configs, blobs
        w.write(1, 0)
        num_ac = state.block_ctx_map.num_ac_contexts()
        combined_map = []
        offset = 0
        total_clusters = 0
        for res in results:
            combined_map.extend(c + total_clusters for c in res.context_map)
            total_clusters += res.num_clusters
        encode_context_map(combined_map, total_clusters, w)
        w.write(1, 0)  # use_prefix_code
        w.write(2, STREAM_LOG_ALPHA - 5)
        for _ in range(total_clusters):
            _encode_uint_config(DEFAULT_UINT_CONFIG, w, STREAM_LOG_ALPHA)
        for res in results:
            w.append_bits_from(res.histo_blob)

    sections = []
    w = BitWriter()
    write_dc_global(w)
    single = fd.num_groups == 1 and fh.passes.num_passes == 1
    if single:
        write_dc_group(w, results[0])
        write_ac_global(w)
        w2 = BitWriter()
        w2.append_bits_from(w)
        sec = results[0].ac_sections[0]
        # histo_bits is 0 for a single DC group; append payload bits
        w2.append_raw_bits(sec, len(sec) * 8)
        sections.append(w2.get_bytes())
    else:
        sections.append(w.get_bytes())
        for res in results:
            w = BitWriter()
            write_dc_group(w, res)
            sections.append(w.get_bytes())
        w = BitWriter()
        write_ac_global(w)
        sections.append(w.get_bytes())
        by_group = {}
        for res in results:
            by_group.update(res.ac_sections)
        for g in range(fd.num_groups):
            sections.append(by_group[g])
    fh.write(writer)
    write_group_offsets([len(s) for s in sections], None, writer)
    writer.zero_pad_to_byte()
    for s in sections:
        writer.append_bytes(s)
