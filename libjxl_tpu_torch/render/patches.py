"""Patch dictionary: rectangles blitted from saved reference frames.

Codec + blitter for the kPatches image feature. Mirrors
dec_patch_dictionary.cc:29-176 (Decode), enc_patch_dictionary.cc
(TokenizePatch ordering), and the blend-mode semantics of
dec_patch_dictionary.h:35-69 / blending.cc.

Context numbers per spec C.4.5 Listing C.2 (patch_dictionary_internal.h).
The reference encoder finds patches with a text-like detector
(FindTextLikePatches); this framework takes patches as explicit encoder
inputs and focuses on exact codec + rendering parity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.fields import pack_signed, unpack_signed

CTX_NUM_REF_PATCH = 0
CTX_REFERENCE_FRAME = 1
CTX_PATCH_SIZE = 2
CTX_PATCH_REFERENCE_POSITION = 3
CTX_PATCH_POSITION = 4
CTX_PATCH_BLEND_MODE = 5
CTX_PATCH_OFFSET = 6
CTX_PATCH_COUNT = 7
CTX_PATCH_ALPHA_CHANNEL = 8
CTX_PATCH_CLAMP = 9
NUM_PATCH_CONTEXTS = 10

# PatchBlendMode (dec_patch_dictionary.h:35-69)
BLEND_NONE = 0
BLEND_REPLACE = 1
BLEND_ADD = 2
BLEND_MUL = 3
BLEND_BLEND_ABOVE = 4
BLEND_BLEND_BELOW = 5
BLEND_ALPHA_WEIGHTED_ADD_ABOVE = 6
BLEND_ALPHA_WEIGHTED_ADD_BELOW = 7
NUM_BLEND_MODES = 8

MAX_NUM_REFERENCE_FRAMES = 4


def uses_alpha(mode: int) -> bool:
    return mode in (BLEND_BLEND_ABOVE, BLEND_BLEND_BELOW,
                    BLEND_ALPHA_WEIGHTED_ADD_ABOVE,
                    BLEND_ALPHA_WEIGHTED_ADD_BELOW)


def uses_clamp(mode: int) -> bool:
    return uses_alpha(mode) or mode == BLEND_MUL


@dataclass
class PatchReferencePosition:
    ref: int
    x0: int
    y0: int
    xsize: int
    ysize: int


@dataclass
class PatchPosition:
    x: int
    y: int
    ref_pos_idx: int


@dataclass
class PatchBlending:
    mode: int = BLEND_NONE
    alpha_channel: int = 0
    clamp: bool = False


@dataclass
class PatchesState:
    ref_positions: list = field(default_factory=list)
    positions: list = field(default_factory=list)
    blendings: list = field(default_factory=list)  # [patch][channel-group]
    blendings_stride: int = 1


def decode_patches(r: BitReader, xsize: int, ysize: int,
                   num_extra_channels: int,
                   reference_frames) -> PatchesState:
    """PatchDictionary::Decode (dec_patch_dictionary.cc:29-176).

    reference_frames: list of (3, H, W) arrays or None per slot."""
    from ..entropy.decode import ANSSymbolReader, decode_histograms

    st = PatchesState()
    st.blendings_stride = num_extra_channels + 1
    code, cmap = decode_histograms(r, NUM_PATCH_CONTEXTS)
    reader = ANSSymbolReader(code, r)

    def read_num(ctx):
        return reader.read_hybrid_uint(ctx, r, cmap)

    num_ref_patch = read_num(CTX_NUM_REF_PATCH)
    num_pixels = xsize * ysize
    max_ref_patches = 1024 + num_pixels // 4
    max_patches = max_ref_patches * 4
    if num_ref_patch > max_ref_patches:
        raise JXLError("too many patches in dictionary")
    total_patches = 0
    for _ in range(num_ref_patch):
        ref = read_num(CTX_REFERENCE_FRAME)
        if ref >= MAX_NUM_REFERENCE_FRAMES or reference_frames is None \
                or ref >= len(reference_frames) \
                or reference_frames[ref] is None:
            raise JXLError("invalid reference frame ID in patches")
        ref_img = reference_frames[ref]
        x0 = read_num(CTX_PATCH_REFERENCE_POSITION)
        y0 = read_num(CTX_PATCH_REFERENCE_POSITION)
        w = read_num(CTX_PATCH_SIZE) + 1
        h = read_num(CTX_PATCH_SIZE) + 1
        if x0 + w > ref_img.shape[-1] or y0 + h > ref_img.shape[-2]:
            raise JXLError("invalid position in reference frame")
        ref_pos = PatchReferencePosition(ref, x0, y0, w, h)
        id_count = read_num(CTX_PATCH_COUNT) + 1
        total_patches += id_count
        if total_patches > max_patches:
            raise JXLError("too many patches in dictionary")
        choose_alpha = num_extra_channels > 1
        for i in range(id_count):
            if i == 0:
                x = read_num(CTX_PATCH_POSITION)
                y = read_num(CTX_PATCH_POSITION)
            else:
                dx = unpack_signed(read_num(CTX_PATCH_OFFSET))
                dy = unpack_signed(read_num(CTX_PATCH_OFFSET))
                x = st.positions[-1].x + dx
                y = st.positions[-1].y + dy
                if x < 0 or y < 0:
                    raise JXLError("invalid patch: negative coordinate")
            if x + w > xsize or y + h > ysize:
                raise JXLError("invalid patch position")
            blend = []
            for _j in range(st.blendings_stride):
                mode = read_num(CTX_PATCH_BLEND_MODE)
                if mode >= NUM_BLEND_MODES:
                    raise JXLError("invalid patch blend mode")
                info = PatchBlending(mode)
                if uses_alpha(mode) and choose_alpha:
                    info.alpha_channel = read_num(CTX_PATCH_ALPHA_CHANNEL)
                    if info.alpha_channel >= num_extra_channels:
                        raise JXLError("invalid alpha channel for blending")
                if uses_clamp(mode):
                    info.clamp = bool(read_num(CTX_PATCH_CLAMP))
                blend.append(info)
            st.positions.append(
                PatchPosition(x, y, len(st.ref_positions)))
            st.blendings.append(blend)
        st.ref_positions.append(ref_pos)
    if not reader.check_final_state():
        raise JXLError("patches ANS final state mismatch")
    return st


def encode_patches(st: PatchesState, w: BitWriter) -> None:
    """PatchDictionaryEncoder::Encode (enc_patch_dictionary.cc)."""
    from ..entropy.encode import Token, build_and_encode_histograms, \
        write_tokens

    tokens = [Token(CTX_NUM_REF_PATCH, len(st.ref_positions))]
    # group positions by ref_pos_idx, preserving order
    by_ref = [[] for _ in st.ref_positions]
    for idx, pos in enumerate(st.positions):
        by_ref[pos.ref_pos_idx].append(idx)
    for rp_idx, rp in enumerate(st.ref_positions):
        tokens.append(Token(CTX_REFERENCE_FRAME, rp.ref))
        tokens.append(Token(CTX_PATCH_REFERENCE_POSITION, rp.x0))
        tokens.append(Token(CTX_PATCH_REFERENCE_POSITION, rp.y0))
        tokens.append(Token(CTX_PATCH_SIZE, rp.xsize - 1))
        tokens.append(Token(CTX_PATCH_SIZE, rp.ysize - 1))
        idxs = by_ref[rp_idx]
        tokens.append(Token(CTX_PATCH_COUNT, len(idxs) - 1))
        for i, idx in enumerate(idxs):
            pos = st.positions[idx]
            if i == 0:
                tokens.append(Token(CTX_PATCH_POSITION, pos.x))
                tokens.append(Token(CTX_PATCH_POSITION, pos.y))
            else:
                prev = st.positions[idxs[i - 1]]
                tokens.append(Token(CTX_PATCH_OFFSET,
                                    pack_signed(pos.x - prev.x)))
                tokens.append(Token(CTX_PATCH_OFFSET,
                                    pack_signed(pos.y - prev.y)))
            for info in st.blendings[idx]:
                tokens.append(Token(CTX_PATCH_BLEND_MODE, info.mode))
                if uses_alpha(info.mode) and st.blendings_stride > 2:
                    tokens.append(Token(CTX_PATCH_ALPHA_CHANNEL,
                                        info.alpha_channel))
                if uses_clamp(info.mode):
                    tokens.append(Token(CTX_PATCH_CLAMP, int(info.clamp)))
    codes, cmap = build_and_encode_histograms(
        [tokens], NUM_PATCH_CONTEXTS, w)
    write_tokens(tokens, codes, cmap, w)


def apply_patches(img: np.ndarray, st: PatchesState, reference_frames,
                  add: bool = True, extra=None, ref_extra=None,
                  alpha_is_premultiplied: bool = False,
                  y_window=None) -> None:
    """Blit all patches into img (3, H, W) in place (AddOneRow analog,
    vectorized over whole patch rectangles).

    Color blend modes kNone/kReplace/kAdd/kMul and the alpha-dependent
    kBlendAbove/Below + kAlphaWeightedAddAbove/Below
    (PerformAlphaBlending / PerformAlphaWeightedAdd, blending.cc:21-119).
    extra: list of (H, W) float planes — the frame's extra channels,
    blended in place per blend[1+k]. ref_extra: per reference slot, list
    of extra-channel planes of that reference frame (alpha source).
    Alpha planes are in [0, 1] units.
    y_window: optional (wy0, wy1) — img holds only image rows
    [wy0, wy1); every patch rect is clipped to the window and written
    in window-local coordinates (the strip decoder's patches stage)."""
    wy0, wy1 = (0, img.shape[1]) if y_window is None else y_window
    for pos, blend in zip(st.positions, st.blendings):
        rp = st.ref_positions[pos.ref_pos_idx]
        # clip the placement rows to the window
        cy0 = max(pos.y, wy0)
        cy1 = min(pos.y + rp.ysize, wy1)
        if cy0 >= cy1:
            continue
        fy0 = rp.y0 + (cy0 - pos.y)
        fg = reference_frames[rp.ref][:, fy0:fy0 + (cy1 - cy0),
                                      rp.x0:rp.x0 + rp.xsize]
        sl = (slice(None), slice(cy0 - wy0, cy1 - wy0),
              slice(pos.x, pos.x + rp.xsize))
        sl2 = (sl[1], sl[2])
        rsl2 = (slice(fy0, fy0 + (cy1 - cy0)),
                slice(rp.x0, rp.x0 + rp.xsize))

        def fg_alpha(info):
            planes = ref_extra[rp.ref] if ref_extra else None
            if planes is None or info.alpha_channel >= len(planes):
                raise JXLError("alpha-blend patch without alpha channel")
            a = planes[info.alpha_channel][rsl2]
            return np.clip(a, 0.0, 1.0) if info.clamp else a

        mode = blend[0].mode
        if mode == BLEND_REPLACE:
            if add:
                img[sl] = fg
            else:
                img[sl] = 0.0
        elif mode == BLEND_ADD:
            if add:
                img[sl] += fg
            else:
                img[sl] -= fg
        elif mode == BLEND_MUL:
            f = np.clip(fg, 0.0, 1.0) if blend[0].clamp else fg
            if add:
                img[sl] *= f
            else:
                safe = np.where(f == 0.0, 1.0, f)
                img[sl] /= safe
        elif mode in (BLEND_BLEND_ABOVE, BLEND_BLEND_BELOW):
            if not add:
                # encoder semantics: the input image IS the background;
                # alpha-blend patches are composited only at decode time
                continue
            fa = fg_alpha(blend[0])
            bg = img[sl]
            if extra is None or blend[0].alpha_channel >= len(extra):
                raise JXLError("alpha-blend patch without frame alpha")
            ba_full = extra[blend[0].alpha_channel]
            ba = ba_full[sl2]
            if alpha_is_premultiplied:
                # premultiplied (blending.cc:33-48)
                if mode == BLEND_BLEND_ABOVE:
                    img[sl] = fg + bg * (1.0 - fa)[None]
                    ba_full[sl2] = fa + ba * (1.0 - fa)
                else:
                    img[sl] = bg + fg * (1.0 - ba)[None]
                    ba_full[sl2] = ba + fa * (1.0 - ba)
            else:
                # non-premultiplied (blending.cc:50-76)
                if mode == BLEND_BLEND_ABOVE:
                    new_a = fa + ba * (1.0 - fa)
                    safe = np.where(new_a == 0.0, 1.0, new_a)
                    img[sl] = (fg * fa[None]
                               + bg * (ba * (1.0 - fa))[None]) / safe[None]
                else:
                    new_a = ba + fa * (1.0 - ba)
                    safe = np.where(new_a == 0.0, 1.0, new_a)
                    img[sl] = (bg * ba[None]
                               + fg * (fa * (1.0 - ba))[None]) / safe[None]
                ba_full[sl2] = new_a
        elif mode in (BLEND_ALPHA_WEIGHTED_ADD_ABOVE,
                      BLEND_ALPHA_WEIGHTED_ADD_BELOW):
            fa = fg_alpha(blend[0])
            if mode == BLEND_ALPHA_WEIGHTED_ADD_BELOW:
                if extra is None or blend[0].alpha_channel >= len(extra):
                    raise JXLError("alpha-weighted-add needs frame alpha")
                fa = extra[blend[0].alpha_channel][sl2]
            if add:
                img[sl] += fg * fa[None]
            else:
                img[sl] -= fg * fa[None]
        # extra-channel blending per channel group (blend[1 + k])
        if extra is not None and len(blend) > 1:
            for k, info in enumerate(blend[1:]):
                if k >= len(extra) or info.mode in (BLEND_NONE,
                                                    BLEND_BLEND_ABOVE,
                                                    BLEND_BLEND_BELOW):
                    continue  # blend modes handled with color above
                planes = ref_extra[rp.ref] if ref_extra else None
                if planes is None or k >= len(planes):
                    continue
                fg_e = planes[k][rsl2]
                if info.mode == BLEND_REPLACE:
                    extra[k][sl2] = fg_e if add else 0.0
                elif info.mode == BLEND_ADD:
                    extra[k][sl2] += fg_e if add else -fg_e
                elif info.mode == BLEND_MUL:
                    f = np.clip(fg_e, 0.0, 1.0) if info.clamp else fg_e
                    if add:
                        extra[k][sl2] *= f
                    else:
                        extra[k][sl2] /= np.where(f == 0.0, 1.0, f)


DOT_SIZE = 5  # extracted dot patch side (enc_detect_dots kEllipseWindow)


def find_dots(xyb: np.ndarray, max_dots: int = 256,
              energy_thresh: float = 0.04):
    """Detect small isolated high-energy spots ("dots") that VarDCT codes
    poorly and extract them as additive patches
    (DetectGaussianEllipses / FindBestPatchDictionary dot path,
    enc_detect_dots.cc + enc_dot_dictionary.cc, simplified: extraction
    without Gaussian refitting).

    xyb: (3, H, W). Returns (sheet (3, 5, 5*n) XYB residuals,
    placements [(sx, 0, 5, 5, [(x, y)])...]) or None."""
    _, h, w = xyb.shape
    if h < 16 or w < 16:
        return None
    # smooth background: separable 5-tap blur
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
    k /= k.sum()
    sm = xyb
    for axis in (-2, -1):
        sm = np.apply_along_axis(
            lambda r: np.convolve(np.pad(r, 2, mode="edge"), k, "valid"),
            axis, sm)
    res = xyb - sm
    weights = np.array([60.0, 4.0, 2.0])[:, None, None]
    energy = ((res * weights) ** 2).sum(axis=0)
    # local maxima over a 5x5 window
    p = np.pad(energy, 2, mode="constant")
    is_max = np.ones_like(energy, dtype=bool)
    for dy in range(5):
        for dx in range(5):
            if dy == 2 and dx == 2:
                continue
            is_max &= energy >= p[dy:dy + h, dx:dx + w]
    half = DOT_SIZE // 2
    cand = np.flatnonzero((is_max & (energy > energy_thresh))[
        half:h - half, half:w - half].reshape(-1))
    if len(cand) == 0:
        return None
    ys, xs = np.unravel_index(cand, (h - 2 * half, w - 2 * half))
    ys = ys + half
    xs = xs + half
    order = np.argsort(-energy[ys, xs])
    picked = []
    for i in order:
        y, x = int(ys[i]), int(xs[i])
        if any(abs(y - py) < DOT_SIZE and abs(x - px) < DOT_SIZE
               for py, px in picked):
            continue
        # isolation: the 9x9 ring outside the 5x5 blob must be quiet
        y0, y1 = max(0, y - 4), min(h, y + 5)
        ring = energy[y0:y1, max(0, x - 4):min(w, x + 5)].sum() \
            - energy[y - half:y + half + 1, x - half:x + half + 1].sum()
        blob = energy[y - half:y + half + 1, x - half:x + half + 1].sum()
        if ring > 0.35 * blob:
            continue
        picked.append((y, x))
        if len(picked) >= max_dots:
            break
    if not picked:
        return None
    sheet = np.zeros((3, DOT_SIZE, DOT_SIZE * len(picked)))
    placements = []
    for i, (y, x) in enumerate(picked):
        # dot content = region minus the surrounding ring's mean, so the
        # FULL spot lands in the patch and the background stays smooth
        y0, y1 = max(0, y - 4), min(h, y + 5)
        x0, x1 = max(0, x - 4), min(w, x + 5)
        region9 = xyb[:, y0:y1, x0:x1]
        blob5 = xyb[:, y - half:y + half + 1, x - half:x + half + 1]
        ring_sum = region9.sum(axis=(1, 2)) - blob5.sum(axis=(1, 2))
        ring_n = region9.shape[1] * region9.shape[2] - DOT_SIZE * DOT_SIZE
        bg = ring_sum / max(ring_n, 1)
        sheet[:, :, i * DOT_SIZE:(i + 1) * DOT_SIZE] = \
            blob5 - bg[:, None, None]
        placements.append((i * DOT_SIZE, 0, DOT_SIZE, DOT_SIZE,
                           [(x - half, y - half)]))
    return sheet, placements


def get_references(st: PatchesState) -> int:
    mask = 0
    for rp in st.ref_positions:
        mask |= 1 << rp.ref
    return mask


# --------------------------------------------------------- text detection
_XYB_DEQUANT = np.array([0.01615, 0.08875, 0.1922])
_XYB_WEIGHTS = np.array([30.0, 3.0, 1.0])
_SIMILAR_THRESHOLD = 0.8
_VERY_SIMILAR_THRESHOLD = 0.03
_MAX_PATCH_SIZE = 32          # kMaxPatchSize (enc_patch_dictionary.h:34)
_MIN_PEAK = 2
_MIN_PATCH_OCCURRENCES = 2
_MIN_MAX_PATCH_SIZE = 20
_DISTANCE_LIMIT = 50


def _screenshot_cells(xyb: np.ndarray) -> np.ndarray:
    """4x4-aligned cells of constant color whose 12x12 neighborhood is
    >=7/8 equal to the cell color (FindTextLikePatches,
    enc_patch_dictionary.cc:271-315)."""
    _, h, w = xyb.shape
    hc, wc = h // 4, w // 4
    if hc == 0 or wc == 0:
        return np.zeros((0, 0), dtype=bool)
    cells = xyb[:, :hc * 4, :wc * 4].reshape(3, hc, 4, wc, 4)
    corner = cells[:, :, 0, :, 0]
    all_same = (np.abs(cells - corner[:, :, None, :, None]) <= 1e-4) \
        .all(axis=(0, 2, 4))
    if not all_same.any():  # photographic content: nothing flat, bail early
        return all_same
    # neighborhood vote: compare each pixel of the 12x12 window around the
    # cell with the cell corner color (missing border pixels don't count)
    pad = np.pad(xyb, ((0, 0), (4, 4 + 3), (4, 4 + 3)),
                 mode="constant", constant_values=np.inf)
    num = np.zeros((hc, wc), dtype=np.int32)
    num_same = np.zeros((hc, wc), dtype=np.int32)
    for iy in range(-4, 8):
        for ix in range(-4, 8):
            px = pad[:, 4 + iy:4 + iy + hc * 4:4, 4 + ix:4 + ix + wc * 4:4]
            valid = np.isfinite(px[0])
            num += valid
            num_same += valid & (np.abs(np.where(valid, px, 0.0) - corner)
                                 <= 1e-4).all(axis=0)
    return all_same & (num_same * 8 >= num * 7)


def find_text_patches(xyb: np.ndarray, max_patches: int = 1024):
    """FindTextLikePatches (enc_patch_dictionary.cc:218-590): flood-fill
    "background" outward from screenshot-like flat cells, take small
    connected components of foreground as candidate patches, dedupe, and
    bin-pack them into a reference sheet.

    The flood fill runs as a frontier-parallel BFS (numpy) rather than
    the reference's sequential queue, so tie-breaks between competing
    source pixels may differ; that only shifts which background color a
    boundary pixel inherits, and all emitted streams stay valid.

    Returns (sheet (3, Hs, Ws) XYB residuals, placements
    [(sx, sy, pw, ph, [(x, y), ...]), ...]) or None."""
    from scipy import ndimage

    _, h, w = xyb.shape
    cells = _screenshot_cells(xyb)
    if not cells.any():
        return None
    hc, wc = cells.shape

    # ---- frontier BFS marking background + its inherited source color
    visited = np.zeros((h, w), dtype=bool)
    src_y = np.zeros((h, w), dtype=np.int32)
    src_x = np.zeros((h, w), dtype=np.int32)
    cy, cx = np.nonzero(cells)
    seed_mask = np.zeros((h, w), dtype=bool)
    for iy in range(4):
        for ix in range(4):
            seed_mask[cy * 4 + iy, cx * 4 + ix] = True
    fy, fx = np.nonzero(seed_mask)
    visited[fy, fx] = True
    src_y[fy, fx] = fy
    src_x[fy, fx] = fx
    fsy, fsx = fy.copy(), fx.copy()
    cell_map = np.zeros((h, w), dtype=bool)
    cell_map[:hc * 4, :wc * 4] = np.repeat(np.repeat(cells, 4, 0), 4, 1)
    while len(fy):
        cand = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                ny, nx = fy + dy, fx + dx
                ok = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
                ny, nx, sy, sx = ny[ok], nx[ok], fsy[ok], fsx[ok]
                ok = ~visited[ny, nx] \
                    & (np.abs(nx - sx) + np.abs(ny - sy) <= _DISTANCE_LIMIT)
                ny, nx, sy, sx = ny[ok], nx[ok], sy[ok], sx[ok]
                if not len(ny):
                    continue
                d = np.abs(xyb[:, ny, nx] - xyb[:, sy, sx])
                same = (d <= 1e-4).all(axis=0)
                similar = (d * _XYB_WEIGHTS[:, None]).sum(axis=0) \
                    <= _SIMILAR_THRESHOLD
                ok = similar & (~cell_map[ny, nx] | same)
                cand.append((ny[ok], nx[ok], sy[ok], sx[ok]))
        if not cand:
            break
        ny = np.concatenate([c[0] for c in cand])
        nx = np.concatenate([c[1] for c in cand])
        sy = np.concatenate([c[2] for c in cand])
        sx = np.concatenate([c[3] for c in cand])
        if not len(ny):
            break
        _, first = np.unique(ny * w + nx, return_index=True)
        ny, nx, sy, sx = ny[first], nx[first], sy[first], sx[first]
        visited[ny, nx] = True
        src_y[ny, nx] = sy
        src_x[ny, nx] = sx
        fy, fx, fsy, fsx = ny, nx, sy, sx
    is_background = visited
    bg = np.zeros_like(xyb)
    vy, vx = np.nonzero(is_background)
    bg[:, vy, vx] = xyb[:, src_y[vy, vx], src_x[vy, vx]]

    # ---- connected components of foreground -> candidate patches
    labels, n = ndimage.label(~is_background, structure=np.ones((3, 3)))
    if n == 0:
        return None
    slices = ndimage.find_objects(labels)
    info = {}  # (h, w, bytes) -> [positions]
    fdata = {}
    for li, sl in enumerate(slices):
        if sl is None:
            continue
        ph = sl[0].stop - sl[0].start
        pw = sl[1].stop - sl[1].start
        if ph > _MAX_PATCH_SIZE or pw > _MAX_PATCH_SIZE:
            continue
        mask = labels[sl] == li + 1
        # border = background 8-neighbors of the CC
        gy0 = max(0, sl[0].start - 1)
        gx0 = max(0, sl[1].start - 1)
        gsl = (slice(gy0, min(h, sl[0].stop + 1)),
               slice(gx0, min(w, sl[1].stop + 1)))
        gmask = np.zeros((gsl[0].stop - gy0, gsl[1].stop - gx0), dtype=bool)
        gmask[sl[0].start - gy0:sl[0].stop - gy0,
              sl[1].start - gx0:sl[1].stop - gx0] = mask
        border = ndimage.binary_dilation(
            gmask, structure=np.ones((3, 3))) & ~gmask \
            & is_background[gsl]
        by, bx = np.nonzero(border)
        if not len(by):
            continue
        bcol = bg[:, by + gy0, bx + gx0]
        ref = bcol[:, 0]
        dist = (np.abs(bcol - ref[:, None])
                * _XYB_WEIGHTS[:, None]).sum(axis=0)
        if (dist > _VERY_SIMILAR_THRESHOLD).any():
            continue
        # a similar-to-background pixel must exist near the bbox
        ny0 = max(0, sl[0].start - 2)
        nx0 = max(0, sl[1].start - 2)
        near = xyb[:, ny0:min(h, sl[0].stop + 2),
                   nx0:min(w, sl[1].stop + 2)]
        ndist = (np.abs(near - ref[:, None, None])
                 * _XYB_WEIGHTS[:, None, None]).sum(axis=0)
        if not (ndist <= _VERY_SIMILAR_THRESHOLD).any():
            continue
        fpix = xyb[:, sl[0], sl[1]] - ref[:, None, None]
        qpix = np.trunc(fpix / _XYB_DEQUANT[:, None, None]).astype(np.int32)
        if np.abs(qpix).max() < _MIN_PEAK:
            continue
        key = (ph, pw, qpix.tobytes())
        info.setdefault(key, []).append((sl[1].start, sl[0].start))
        fdata.setdefault(key, fpix)
    # keep patches occurring at least twice
    kept = [(k, v) for k, v in info.items()
            if len(v) >= _MIN_PATCH_OCCURRENCES]
    if not kept or max(k[0] * k[1] for k, _ in kept) < _MIN_MAX_PATCH_SIZE:
        return None
    kept.sort(key=lambda kv: -(kv[0][0] * kv[0][1]))
    kept = kept[:max_patches]

    # ---- first-fit bin packing into the reference sheet
    # (enc_patch_dictionary.cc:640-710)
    total = sum(k[0] * k[1] for k, _ in kept)
    max_w = max(k[1] for k, _ in kept)
    max_h = max(k[0] for k, _ in kept)
    ref_w = max(max_w, int(np.sqrt(total)))
    ref_h = max(max_h, int(np.sqrt(total)))
    while True:
        ref_w = int(ref_w * 1.05) + 1
        ref_h = int(ref_h * 1.05) + 1
        occupied = np.zeros((ref_h, ref_w), dtype=bool)
        spots = []
        ok = True
        for (ph, pw, _), _pos in kept:
            placed = False
            for y0 in range(ref_h - ph + 1):
                for x0 in range(ref_w - pw + 1):
                    if not occupied[y0:y0 + ph, x0:x0 + pw].any():
                        occupied[y0:y0 + ph, x0:x0 + pw] = True
                        spots.append((x0, y0))
                        placed = True
                        break
                if placed:
                    break
            if not placed:
                ok = False
                break
        if ok:
            break
    sheet = np.zeros((3, ref_h, ref_w))
    placements = []
    for ((ph, pw, _), poses), (x0, y0) in zip(kept, spots):
        key = (ph, pw, _)
        sheet[:, y0:y0 + ph, x0:x0 + pw] = fdata[key]
        placements.append((x0, y0, pw, ph, poses))
    return sheet, placements
