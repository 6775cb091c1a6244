"""jpegli encoder: psychovisually tuned standard JPEG output.

The sibling-codec analog of the reference's lib/jpegli encoder
(encode.cc, encode_streaming.cc, dct-inl.h): float DCT, distance-scaled
YCbCr quant tables, adaptive dead-zone quantization driven by the
jpegli AQ field, DC hysteresis, and two-pass optimal Huffman coding.
Produces standard baseline JPEG bytes decodable by any libjpeg.

Structure is original: whole-image vectorized NumPy (batched DCT via
ops/dct, vectorized zero-bias quantization and run-length histograms)
instead of the reference's row-streaming per-MCU loops.
"""

from __future__ import annotations

import struct

import numpy as np

from ..base.status import JXLError
from ..ops.dct import dct2d
from .aq import compute_aq_strength
from .quant import make_quant_tables, quality_to_distance, zero_bias_params
from ..jpeg.data import Component, HuffmanTable, JPEGData, ZIGZAG
from ..jpeg.writer import write_jpeg


def _rgb_to_ycbcr(rgb: np.ndarray):
    """Full-range BT.601 (color_transform.cc RGBToYCbCr)."""
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return y, cb, cr


def _downsample2(plane: np.ndarray) -> np.ndarray:
    """2x2 box average (downsample.cc DownsampleRow2x1 + row pairs)."""
    h, w = plane.shape
    return plane.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))


def _csize(v: np.ndarray) -> np.ndarray:
    """JPEG magnitude-category size of each value (vectorized
    bit_length of |v|)."""
    av = np.abs(v).astype(np.int64)
    out = np.zeros(av.shape, dtype=np.int32)
    nz = av > 0
    out[nz] = np.floor(np.log2(av[nz])).astype(np.int32) + 1
    return out


def _quantize_component(plane: np.ndarray, quant_nat: np.ndarray,
                        zb_offset: np.ndarray, zb_mul: np.ndarray,
                        aq: np.ndarray | None) -> np.ndarray:
    """Float DCT + zero-bias quantization + DC hysteresis
    (dct-inl.h QuantizeBlock/ComputeCoefficientBlock).  plane is
    (H, W) in [0, 255] padded to 8-multiples; aq is the per-block
    strength sampled at this component's grid (or None).  Returns
    (nby, nbx, 64) int32 in NATURAL order."""
    h, w = plane.shape
    nby, nbx = h // 8, w // 8
    blocks = plane.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
    f8 = dct2d(blocks.reshape(-1, 8, 8).astype(np.float64))
    # ops.dct2d returns the transposed orthonormal DCT at 1/8 scale,
    # which is exactly the reference's internal dct value; natural
    # raster order needs the transpose back.
    dct = f8.transpose(0, 2, 1).reshape(-1, 64)
    qmc = 8.0 / quant_nat.astype(np.float64)
    qval = dct * qmc
    if aq is None:
        strength = np.zeros((dct.shape[0], 1))
    else:
        strength = aq.reshape(-1, 1).astype(np.float64)
    threshold = zb_offset[None, :] + zb_mul[None, :] * strength
    out = np.where(np.abs(qval) >= threshold, np.round(qval), 0.0)
    out = out.astype(np.int32)

    # DC: centered value with hysteresis against the previous block's
    # quantized DC (raster order), dct-inl.h:244-252
    dc = (dct[:, 0] - 128.0) * qmc[0]
    dc_thresh = threshold[:, 0]
    dc_round = np.round(dc).astype(np.int32)
    last = 0
    dcs = np.empty(dct.shape[0], dtype=np.int32)
    for i in range(dct.shape[0]):
        if abs(dc[i] - last) < dc_thresh[i]:
            dcs[i] = last
        else:
            dcs[i] = dc_round[i]
            last = dcs[i]
    out[:, 0] = dcs
    return out.reshape(nby, nbx, 64)


def _dc_scan_order(comp: Component, hmax: int, vmax: int) -> np.ndarray:
    """DC values of a component in the MCU visit order the scan writer
    uses (my, mx, by, bx) — differs from raster order when the
    component has sampling factors > 1."""
    dc = comp.coeffs[:, :, 0]
    nby, nbx = dc.shape
    vs, hs = comp.v_samp, comp.h_samp
    if vs == 1 and hs == 1:
        return dc.reshape(-1)
    return dc.reshape(nby // vs, vs, nbx // hs, hs) \
        .transpose(0, 2, 1, 3).reshape(-1)


def _ac_histogram(zz: np.ndarray, hist: np.ndarray) -> None:
    """Accumulate run/size symbol counts for one component's zigzag
    coefficients (nb, 64) into hist (256,)."""
    ac = zz[:, 1:]
    nb = ac.shape[0]
    nzmask = ac != 0
    any_nz = nzmask.any(axis=1)
    last_nz = np.where(any_nz, 63 - np.argmax(nzmask[:, ::-1], axis=1), 0)
    # EOB for every block whose last nonzero is before position 63
    hist[0x00] += int(np.sum(last_nz != 63))
    bi, ki = np.nonzero(nzmask)
    if len(bi) == 0:
        return
    k = ki + 1  # zigzag position
    prev = np.empty(len(bi), dtype=np.int64)
    prev[0] = 0
    same = bi[1:] == bi[:-1]
    prev[1:] = np.where(same, k[:-1], 0)
    runs = k - prev - 1
    hist[0xF0] += int(np.sum(runs // 16))
    sizes = _csize(ac[bi, ki])
    syms = ((runs % 16) << 4) | sizes
    np.add.at(hist, syms, 1)


def _optimal_huffman(freq: np.ndarray, table_class: int,
                     table_id: int) -> HuffmanTable:
    """Length-limited (16) optimal Huffman code over the 256 JPEG
    symbols, libjpeg jpeg_gen_optimal_table-style: pairwise merge with
    a reserved 257th symbol so no code is all ones."""
    freq = np.concatenate([freq.astype(np.int64), [1]])
    others = np.full(257, -1, dtype=np.int64)
    codesize = np.zeros(257, dtype=np.int64)
    while True:
        active = np.nonzero(freq > 0)[0]
        if len(active) <= 1:
            break
        order = active[np.lexsort((-active, freq[active]))]
        c1, c2 = int(order[0]), int(order[1])
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = np.zeros(33, dtype=np.int64)
    for size in codesize[codesize > 0]:
        bits[min(int(size), 32)] += 1
    # limit code lengths to 16 (classic bit-moving adjustment)
    for length in range(32, 16, -1):
        while bits[length] > 0:
            j = length - 2
            while bits[j] == 0:
                j -= 1
            bits[length] -= 2
            bits[length - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    # drop the reserved symbol's code (one code of the longest length)
    for length in range(16, 0, -1):
        if bits[length] > 0:
            bits[length] -= 1
            break
    syms = np.nonzero(codesize[:256] > 0)[0]
    syms = syms[np.lexsort((syms, codesize[syms]))]
    return HuffmanTable(table_class=table_class, table_id=table_id,
                        counts=[int(b) for b in bits[1:17]],
                        values=[int(s) for s in syms])


_JFIF = (0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def encode_jpegli(rgb: np.ndarray, distance: float | None = None,
                  quality: int | None = None, subsampling: str = "444",
                  std_tables: bool = False, adaptive: bool = True,
                  optimize: bool = True, progressive: int = 0) -> bytes:
    """Encode (H, W, 3) or (H, W) / (H, W, 1) uint8 pixels to JPEG.

    distance is the butteraugli target (default 1.0); quality, if
    given, maps through quality_to_distance (encode.cc:838).
    subsampling: "444" or "420".  progressive: 0 = sequential
    baseline, 1/2 = the reference's default progressive scan scripts
    (jpegli_set_progressive_level, encode.cc:925).
    """
    if quality is not None:
        distance = quality_to_distance(quality)
    if distance is None:
        distance = 1.0
    rgb = np.asarray(rgb)
    if rgb.ndim == 2:
        rgb = rgb[:, :, None]
    gray = rgb.shape[2] == 1
    if gray:
        subsampling = "444"
    elif rgb.shape[2] != 3:
        raise JXLError(f"jpegli: expected 1 or 3 channels, "
                       f"got {rgb.shape[2]}")
    h, w = rgb.shape[:2]
    if h == 0 or w == 0:
        raise JXLError("jpegli: empty image")

    tables = make_quant_tables(distance, color="ycbcr",
                               subsampling=subsampling,
                               std_tables=std_tables)
    zb_offset, zb_mul = zero_bias_params(tables, adaptive=adaptive)

    if gray:
        full = [rgb[:, :, 0].astype(np.float32)]
        samps = [(1, 1)]
        quant_idx = [0]
    else:
        if subsampling == "420":
            samps = [(2, 2), (1, 1), (1, 1)]
        elif subsampling == "444":
            samps = [(1, 1), (1, 1), (1, 1)]
        else:
            raise JXLError(f"jpegli: unsupported subsampling "
                           f"{subsampling!r}")
        full = list(_rgb_to_ycbcr(rgb))
        # std tables: both chroma components share table 1
        quant_idx = [0, 1, min(2, tables.shape[0] - 1)]

    hmax = max(s[0] for s in samps)
    vmax = max(s[1] for s in samps)
    # pad full-res planes to whole MCUs, then downsample chroma: every
    # component plane lands exactly on its MCU-aligned block grid
    padded = []
    for plane, (hs, vs) in zip(full, samps):
        p = np.asarray(plane, dtype=np.float32)
        ph = (-p.shape[0]) % (8 * vmax)
        pw = (-p.shape[1]) % (8 * hmax)
        if ph or pw:
            p = np.pad(p, ((0, ph), (0, pw)), mode="edge")
        fy, fx = vmax // vs, hmax // hs
        if fy > 1 or fx > 1:
            p = _downsample2(p)
        padded.append(p)

    aq_field = None
    if adaptive:
        y_quant_01 = int(tables[0][1])
        aq_field = compute_aq_strength(padded[0], y_quant_01)

    comps = []
    for ci, (plane, (hs, vs)) in enumerate(zip(padded, samps)):
        qidx = quant_idx[ci] if not gray else 0
        aq = None
        if aq_field is not None:
            vf = vmax // vs
            hf = hmax // hs
            nby, nbx = plane.shape[0] // 8, plane.shape[1] // 8
            aq = aq_field[:nby * vf:vf, :nbx * hf:hf]
        nat = _quantize_component(plane, tables[qidx].astype(np.float64),
                                  zb_offset[ci], zb_mul[ci], aq)
        zz = nat.reshape(-1, 64)[:, ZIGZAG].reshape(nat.shape)
        comp = Component(comp_id=ci + 1, h_samp=hs, v_samp=vs,
                         quant_idx=qidx,
                         dc_table=0 if ci == 0 else 1,
                         ac_table=0 if ci == 0 else 1,
                         width_in_blocks=plane.shape[1] // 8,
                         height_in_blocks=plane.shape[0] // 8,
                         coeffs=zz.astype(np.int32))
        comps.append(comp)

    n_qt = 1 if gray else tables.shape[0]
    quant_zz = {i: [int(v) for v in tables[i][ZIGZAG]]
                for i in range(n_qt)}
    if progressive:
        if progressive not in (1, 2):
            raise JXLError(f"jpegli: progressive level must be 0-2, "
                           f"got {progressive}")
        from .progressive import write_progressive_jpeg

        return write_progressive_jpeg(w, h, comps, quant_zz, [_JFIF],
                                      progressive)

    # Huffman tables: optimal two-pass (encode_finish.cc) or the
    # Annex-K defaults
    huffman = []
    n_tabs = 1 if gray else 2
    for tab in range(n_tabs):
        dc_hist = np.zeros(256, dtype=np.int64)
        ac_hist = np.zeros(256, dtype=np.int64)
        for comp in comps:
            if comp.dc_table != tab:
                continue
            dc = _dc_scan_order(comp, hmax, vmax)
            diffs = np.diff(dc, prepend=0)
            np.add.at(dc_hist, _csize(diffs), 1)
            _ac_histogram(comp.coeffs.reshape(-1, 64), ac_hist)
        if not optimize:
            from .std_huffman import std_dc_table, std_ac_table
            huffman.append(std_dc_table(tab))
            huffman.append(std_ac_table(tab))
        else:
            huffman.append(_optimal_huffman(dc_hist, 0, tab))
            huffman.append(_optimal_huffman(ac_hist, 1, tab))

    jd = JPEGData(
        width=w, height=h, precision=8,
        components=comps,
        quant=quant_zz,
        quant_order=[(i, 0) for i in range(n_qt)],
        huffman=huffman,
        markers=[_JFIF],
        scan_components=comps,
    )
    return write_jpeg(jd)


def encode_jpegli_quality(rgb: np.ndarray, quality: int = 90,
                          **kw) -> bytes:
    return encode_jpegli(rgb, quality=quality, **kw)
