"""Modular (sub-)image encode/decode.

Mirrors modular/encoding/encoding.cc (ModularDecode, encoding.cc:530-652)
and enc_encoding.cc (ModularEncode, :549-734). Stream layout per group:
GroupHeader bundle | [local MA tree + histograms] | channel token stream.
"""

from __future__ import annotations

import numpy as np

from ..base.status import JXLError
from ..io.bits import BitReader
from ..io.fields import Bundle, BitsOffset, U32Enc, Val
from ..entropy.decode import ANSSymbolReader, decode_histograms
from ..entropy.encode import TokenArray
from .image import ModularImage
from .predict import NUM_NONREF_PROPERTIES, P_GRADIENT, P_ZERO, WeightedHeader
from .tree import Tree, decode_tree, filter_tree, num_tree_contexts


class GroupHeader(Bundle):
    """modular/encoding/encoding.h:32-55."""

    def visit_fields(self, v):
        v.bool_(self, False, "use_global_tree")
        v.visit_nested(self, self.wp_header)
        # nb_transforms: the streams this copy reads and writes have none
        n = v.u32_val(0, U32Enc(Val(0), Val(1), BitsOffset(4, 2),
                                BitsOffset(8, 18)), 0)
        if n:
            raise JXLError("modular transforms: not in this copy")

    def set_default(self):
        self.use_global_tree = False
        self.wp_header = WeightedHeader()


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

    # the native C decoder (native/modular_decode.c): WP-free trees on
    # non-reference properties, the trees this copy's encoder writes
    from ..native_ext import (NativeCodes, NativeTree, decode_channel_native,
                              get_lib)

    lib = get_lib()
    if uses_wp or max_prop >= NUM_NONREF_PROPERTIES - 1 or lib is None:
        raise JXLError("a weighted-predictor or reference-property tree, "
                       "or no native library: not in this copy")
    ncodes = getattr(reader, "_native_codes", None)
    if ncodes is None:
        ncodes = NativeCodes(reader.code, context_map)
        reader._native_codes = ncodes
    out, bitpos, state = decode_channel_native(
        lib, r.data, r.total_bits_consumed(), reader.state,
        ncodes, NativeTree(tree), chan, group_id, w, h)
    channel.data[:, :] = out
    r.seek_bits(bitpos)
    reader.state = state


def modular_decode(r: BitReader, image: ModularImage, group_id: int = 0,
                   options: ModularOptions = None, global_tree=None,
                   global_code=None, global_ctx_map=None,
                   header: GroupHeader = None) -> GroupHeader:
    """ModularDecode + ModularGenericDecompress (encoding.cc:530-652)."""
    if options is None:
        options = ModularOptions()
    if not image.channel:
        return header
    if header is None:
        header = GroupHeader()
    header.read(r)
    nb_channels = len(image.channel)
    num_chans = 0
    for i, ch in enumerate(image.channel):
        if ch.w == 0 or ch.h == 0:
            continue
        if i >= image.nb_meta_channels and (ch.w > options.max_chan_size
                                            or ch.h > options.max_chan_size):
            break
        num_chans += 1
    if num_chans == 0:
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
    reader = ANSSymbolReader(code, r)
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
    except OverflowError as e:
        # crafted streams can drive tree-leaf multipliers / hybrid-uint
        # values past int32; numpy>=2 raises OverflowError on the store,
        # which must surface as a decode error, not a crash
        raise JXLError(f"modular sample out of int32 range: {e}") from e
    return header


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
    raise JXLError("a tree the vectorized tokenizer declines: not in this "
                   "copy")

