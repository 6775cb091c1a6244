"""Modular (sub-)image encode/decode.

Mirrors modular/encoding/encoding.cc (ModularDecode, encoding.cc:530-652)
and enc_encoding.cc (ModularEncode, :549-734). Stream layout per group:
GroupHeader bundle | [local MA tree + histograms] | channel token stream.
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.fields import Bundle, BitsOffset, U32Enc, Val, pack_signed, unpack_signed
from ..entropy.decode import ANSSymbolReader, decode_histograms
from ..entropy.encode import (Token, TokenArray,
                              build_and_encode_histograms, write_tokens)
from .image import Channel, ModularImage
from .predict import (
    GRADIENT_PROP,
    NUM_NONREF_PROPERTIES,
    EXTRA_PROPS_PER_CHANNEL,
    P_GRADIENT,
    P_WEIGHTED,
    P_ZERO,
    WeightedHeader,
    WeightedState,
    clamped_gradient,
    compute_properties,
    neighbors,
    predict_one,
)
from .transforms import Transform
from .tree import (
    Tree,
    decode_tree,
    encode_tree,
    filter_tree,
    lookup_tree,
    make_fixed_tree,
    num_tree_contexts,
)


class GroupHeader(Bundle):
    """modular/encoding/encoding.h:32-55."""

    def visit_fields(self, v):
        v.bool_(self, False, "use_global_tree")
        v.visit_nested(self, self.wp_header)
        n = len(self.transforms) if not v.is_reading() else 0
        n = v.u32_val(n, U32Enc(Val(0), Val(1), BitsOffset(4, 2),
                                BitsOffset(8, 18)), 0)
        if v.is_reading():
            self.transforms = [Transform() for _ in range(n)]
        for t in self.transforms:
            v.visit_nested(self, t)

    def set_default(self):
        self.use_global_tree = False
        self.wp_header = WeightedHeader()
        self.transforms = []


class ModularOptions:
    """Subset of modular/options.h:59-120 used by this implementation."""

    def __init__(self, max_chan_size: int = 0xFFFFFF, group_dim: int = 0x1FFFFFFF,
                 predictor: int = None, nb_repeats: float = 0.5,
                 max_properties: int = 0, wp_mode: int = 0):
        self.max_chan_size = max_chan_size
        self.group_dim = group_dim
        self.predictor = predictor
        self.nb_repeats = nb_repeats
        self.max_properties = max_properties
        self.wp_mode = wp_mode


def _precompute_references(image: ModularImage, chan: int, y: int,
                           num_extra_props: int, out: np.ndarray) -> None:
    """context_predict.h:380-412: per-row reference properties from earlier
    same-shaped channels."""
    ch = image.channel[chan]
    out[:, :] = 0
    offset = 0
    for j in range(chan - 1, -1, -1):
        if offset >= num_extra_props:
            break
        chj = image.channel[j]
        if (chj.w != ch.w or chj.h != ch.h or chj.hshift != ch.hshift
                or chj.vshift != ch.vshift):
            continue
        rpp = chj.data[y].astype(np.int64)
        rprev = chj.data[y - 1].astype(np.int64) if y else rpp
        vleft = np.concatenate(([0], rpp[:-1]))
        vtop = rprev if y else vleft
        vtopleft = np.concatenate(([0], rprev[:-1])) if y else vleft
        if y:
            vtopleft[0] = vleft[0]
        vpred = clamped_gradient(vtop, vleft, vtopleft) \
            if False else _cg_arrays(vleft, vtop, vtopleft)
        out[:, offset + 0] = np.abs(rpp)
        out[:, offset + 1] = rpp
        out[:, offset + 2] = np.abs(rpp - vpred)
        out[:, offset + 3] = rpp - vpred
        offset += EXTRA_PROPS_PER_CHANNEL


def _cg_arrays(vleft, vtop, vtopleft):
    m = np.minimum(vtop, vleft)
    M = np.maximum(vtop, vleft)
    grad = vtop + vleft - vtopleft
    return np.where(vtopleft < m, M, np.where(vtopleft > M, m, grad))


def _decode_channel(r: BitReader, reader: ANSSymbolReader, context_map,
                    global_tree: Tree, wp_header: WeightedHeader, chan: int,
                    group_id: int, image: ModularImage) -> None:
    """DecodeModularChannelMAANS (encoding.cc:143-484)."""
    channel = image.channel[chan]
    w, h = channel.w, channel.h
    if w == 0 or h == 0:
        return
    tree, uses_wp, max_prop = filter_tree(global_tree, (chan, group_id))

    # Native C fast paths (native/modular_decode.c): WP-free trees and
    # weighted-predictor trees, both limited to non-reference properties
    # and plain rANS streams.
    # filter_tree already folds every WP leaf/property into uses_wp
    needs_wp = uses_wp
    if (max_prop < NUM_NONREF_PROPERTIES - (0 if needs_wp else 1)
            and not reader.use_prefix_code
            and getattr(reader, "lz77_window", None) is None):
        from ..native_ext import (
            NativeCodes,
            NativeTree,
            decode_channel_native,
            decode_channel_wp_native,
            get_lib,
        )

        lib = get_lib()
        if lib is not None:
            ncodes = getattr(reader, "_native_codes", None)
            if ncodes is None:
                ncodes = NativeCodes(reader.code, context_map)
                reader._native_codes = ncodes
            if needs_wp:
                out, bitpos, state = decode_channel_wp_native(
                    lib, r.data, r.total_bits_consumed(), reader.state,
                    ncodes, NativeTree(tree), wp_header, chan, group_id,
                    w, h)
            else:
                out, bitpos, state = decode_channel_native(
                    lib, r.data, r.total_bits_consumed(), reader.state,
                    ncodes, NativeTree(tree), chan, group_id, w, h)
            channel.data[:, :] = out
            r.seek_bits(bitpos)
            reader.state = state
            return

    def make_pixel(v, multiplier, offset):
        return unpack_signed(v) * multiplier + offset

    if len(tree) == 1:
        node = tree[0]
        ctx = context_map[node.context]
        if node.predictor == P_ZERO:
            plane = channel.data
            for y in range(h):
                row = plane[y]
                for x in range(w):
                    v = reader.read_hybrid_uint_clustered(ctx, r)
                    row[x] = make_pixel(v, node.multiplier,
                                        node.predictor_offset)
            return
        if (node.predictor == P_GRADIENT and node.predictor_offset == 0
                and node.multiplier == 1):
            plane = channel.data
            for y in range(h):
                row = plane[y]
                prow = plane[y - 1] if y else None
                for x in range(w):
                    left = int(row[x - 1]) if x else (int(prow[x]) if y else 0)
                    top = int(prow[x]) if y else left
                    topleft = int(prow[x - 1]) if (x and y) else left
                    guess = clamped_gradient(top, left, topleft)
                    v = reader.read_hybrid_uint_clustered(ctx, r)
                    row[x] = unpack_signed(v) + guess
            return
    # general path
    nprops = max(max_prop + 1, NUM_NONREF_PROPERTIES)
    if nprops > NUM_NONREF_PROPERTIES:
        extra = nprops - NUM_NONREF_PROPERTIES
        extra = -(-extra // EXTRA_PROPS_PER_CHANNEL) * EXTRA_PROPS_PER_CHANNEL
        nprops = NUM_NONREF_PROPERTIES + extra
    num_refs = nprops - NUM_NONREF_PROPERTIES
    props = [0] * nprops
    references = np.zeros((w, max(num_refs, 1)), dtype=np.int64)
    wp_state = WeightedState(wp_header, w, h)
    plane = channel.data
    for y in range(h):
        props[0], props[1] = chan, group_id
        props[2] = y
        props[9] = 0
        if num_refs:
            _precompute_references(image, chan, y, num_refs, references)
        row = plane[y]
        for x in range(w):
            left, top, topleft, topright, leftleft, toptop, trr = \
                neighbors(plane, x, y, w)
            compute_properties(props, x, y, w, left, top, topleft, topright,
                               leftleft, toptop)
            if uses_wp:
                wp_pred, wp_prop = wp_state.predict(
                    x, y, w, top, left, topright, topleft, toptop,
                    compute_property=True)
                props[NUM_NONREF_PROPERTIES - 1] = wp_prop
            else:
                wp_pred = 0
            for i in range(num_refs):
                props[NUM_NONREF_PROPERTIES + i] = int(references[x][i])
            leaf = lookup_tree(tree, props)
            v = reader.read_hybrid_uint_clustered(
                context_map[leaf.context], r)
            guess = leaf.predictor_offset + predict_one(
                leaf.predictor, left, top, toptop, topleft, topright,
                leftleft, trr, wp_pred)
            val = unpack_signed(v) * leaf.multiplier + guess
            row[x] = val
            if uses_wp:
                wp_state.update_errors(val, x, y, w)


def modular_decode(r: BitReader, image: ModularImage, group_id: int = 0,
                   options: ModularOptions = None, global_tree=None,
                   global_code=None, global_ctx_map=None,
                   undo_transforms: bool = True,
                   header: GroupHeader = None) -> GroupHeader:
    """ModularDecode + ModularGenericDecompress (encoding.cc:530-652)."""
    if options is None:
        options = ModularOptions()
    if not image.channel:
        return header
    if header is None:
        header = GroupHeader()
    header.read(r)
    image.transform = header.transforms
    for t in header.transforms:
        t.meta_apply(image)
    nb_channels = len(image.channel)
    num_chans = 0
    distance_multiplier = 0
    for i, ch in enumerate(image.channel):
        if ch.w == 0 or ch.h == 0:
            continue
        if i >= image.nb_meta_channels and (ch.w > options.max_chan_size
                                            or ch.h > options.max_chan_size):
            break
        distance_multiplier = max(distance_multiplier, ch.w)
        num_chans += 1
    if num_chans == 0:
        if undo_transforms:
            _undo_transforms(image, header)
        return header
    if not header.use_global_tree:
        max_tree_size = 1024
        for i, ch in enumerate(image.channel):
            if i >= image.nb_meta_channels and (
                    ch.w > options.max_chan_size
                    or ch.h > options.max_chan_size):
                break
            max_tree_size += ch.w * ch.h
        max_tree_size = min(1 << 20, max_tree_size)
        tree = decode_tree(r, max_tree_size)
        code, context_map = decode_histograms(r, num_tree_contexts(tree))
    else:
        if global_tree is None or global_code is None:
            raise JXLError("global tree requested but unavailable")
        tree, code, context_map = global_tree, global_code, global_ctx_map
    reader = ANSSymbolReader(code, r, distance_multiplier)
    try:
        for i in range(nb_channels):
            ch = image.channel[i]
            if ch.w == 0 or ch.h == 0:
                continue
            if i >= image.nb_meta_channels and (
                    ch.w > options.max_chan_size
                    or ch.h > options.max_chan_size):
                break
            _decode_channel(r, reader, context_map, tree,
                            header.wp_header, i, group_id, image)
        if not reader.check_final_state():
            raise JXLError("modular ANS final state mismatch")
        if undo_transforms:
            _undo_transforms(image, header)
    except OverflowError as e:
        # crafted streams can drive tree-leaf multipliers / hybrid-uint
        # values past int32; numpy>=2 raises OverflowError on the store,
        # which must surface as a decode error, not a crash
        raise JXLError(f"modular sample out of int32 range: {e}") from e
    return header


def _undo_transforms(image: ModularImage, header: GroupHeader) -> None:
    for t in reversed(image.transform):
        t.inverse(image, header.wp_header)
    image.transform = []


# ------------------------------------------------------------------- encoding
def _tokenize_channel(image: ModularImage, chan: int, group_id: int,
                      tree: Tree, wp_header: WeightedHeader, tokens: list):
    """Generate (context, value) tokens for one channel under `tree`
    (enc_encoding.cc:102-320 analog; tree is in decoder BFS layout)."""
    channel = image.channel[chan]
    w, h = channel.w, channel.h
    if w == 0 or h == 0:
        return
    ftree, uses_wp, max_prop = filter_tree(tree, (chan, group_id))
    plane = channel.data
    if len(ftree) > 1 and not uses_wp and max_prop < NUM_NONREF_PROPERTIES - 1:
        from .learn import tokenize_channel_vectorized

        if tokenize_channel_vectorized(plane, chan, group_id, tree, tokens):
            return
    if len(ftree) == 1 and not uses_wp:
        node = ftree[0]
        data = plane.astype(np.int64)
        if node.predictor == P_ZERO:
            residuals = data - node.predictor_offset
        elif node.predictor == P_GRADIENT and node.predictor_offset == 0:
            # edge semantics (context_predict.h:493-500):
            # left(x=0, y>0) = top; left(0,0) = 0; top(y=0) = left;
            # topleft(x=0 or y=0) = left.
            left = np.zeros_like(data)
            left[:, 1:] = data[:, :-1]
            left[1:, 0] = data[:-1, 0]
            top = np.empty_like(data)
            top[1:] = data[:-1]
            top[0] = left[0]
            topleft = np.zeros_like(data)
            topleft[1:, 1:] = data[:-1, :-1]
            topleft[:, 0] = left[:, 0]
            topleft[0, 1:] = left[0, 1:]
            guess = _cg_arrays(left, top, topleft)
            residuals = data - guess
        else:
            residuals = None
        if residuals is not None:
            if node.multiplier != 1:
                if np.any(residuals % node.multiplier):
                    raise JXLError("residuals not divisible by multiplier")
                residuals //= node.multiplier
            ctx = node.context
            flat = residuals.reshape(-1)
            packed = np.where(flat >= 0, flat * 2, -flat * 2 - 1)
            tokens.append(TokenArray(ctx, packed))
            return
    # general path (scalar)
    nprops = max(max_prop + 1, NUM_NONREF_PROPERTIES)
    if nprops > NUM_NONREF_PROPERTIES:
        extra = nprops - NUM_NONREF_PROPERTIES
        extra = -(-extra // EXTRA_PROPS_PER_CHANNEL) * EXTRA_PROPS_PER_CHANNEL
        nprops = NUM_NONREF_PROPERTIES + extra
    num_refs = nprops - NUM_NONREF_PROPERTIES
    props = [0] * nprops
    references = np.zeros((w, max(num_refs, 1)), dtype=np.int64)
    wp_state = WeightedState(wp_header, w, h)
    for y in range(h):
        props[0], props[1] = chan, group_id
        props[2] = y
        props[9] = 0
        if num_refs:
            _precompute_references(image, chan, y, num_refs, references)
        row = plane[y]
        for x in range(w):
            left, top, topleft, topright, leftleft, toptop, trr = \
                neighbors(plane, x, y, w)
            compute_properties(props, x, y, w, left, top, topleft, topright,
                               leftleft, toptop)
            if uses_wp:
                wp_pred, wp_prop = wp_state.predict(
                    x, y, w, top, left, topright, topleft, toptop,
                    compute_property=True)
                props[NUM_NONREF_PROPERTIES - 1] = wp_prop
            else:
                wp_pred = 0
            for i in range(num_refs):
                props[NUM_NONREF_PROPERTIES + i] = int(references[x][i])
            leaf = lookup_tree(ftree, props)
            guess = leaf.predictor_offset + predict_one(
                leaf.predictor, left, top, toptop, topleft, topright,
                leftleft, trr, wp_pred)
            val = int(row[x])
            residual = val - guess
            if leaf.multiplier != 1:
                if residual % leaf.multiplier:
                    raise JXLError("residual not divisible by multiplier")
                residual //= leaf.multiplier
            tokens.append(Token(leaf.context, pack_signed(residual)))
            if uses_wp:
                wp_state.update_errors(val, x, y, w)


def modular_encode(image: ModularImage, w: BitWriter, group_id: int = 0,
                   options: ModularOptions = None, tree: Tree = None,
                   header: GroupHeader = None,
                   global_codes=None) -> None:
    """ModularEncode (enc_encoding.cc:549-734).

    `tree` must be in decoder (BFS) layout; defaults to a fixed
    ClampedGradient tree. When global_codes is given (use_global_tree), only
    the channel token stream is emitted with the provided
    (tree, codes, context_map) triple.
    """
    if options is None:
        options = ModularOptions()
    if header is None:
        header = GroupHeader()
    header.transforms = image.transform
    use_global = global_codes is not None
    header.use_global_tree = use_global
    header.write(w)
    if not image.channel:
        return
    if use_global:
        dec_tree, codes, context_map = global_codes
    else:
        if tree is None:
            pred = options.predictor if options.predictor is not None \
                else P_GRADIENT
            tree = make_fixed_tree(pred)
        # Writes the tree and returns it in decoder (BFS) layout, which is
        # what channel tokenization must use for context ids.
        dec_tree = encode_tree(tree, w)
    tokens: list = []
    nb_channels = len(image.channel)
    for i in range(nb_channels):
        ch = image.channel[i]
        if ch.w == 0 or ch.h == 0:
            continue
        if i >= image.nb_meta_channels and (ch.w > options.max_chan_size
                                            or ch.h > options.max_chan_size):
            break
        _tokenize_channel(image, i, group_id, dec_tree, header.wp_header,
                          tokens)
    if not use_global:
        codes, context_map = build_and_encode_histograms(
            [tokens], num_tree_contexts(dec_tree), w)
    write_tokens(tokens, codes, context_map, w)
