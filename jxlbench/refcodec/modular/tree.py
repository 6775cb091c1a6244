"""MA (meta-adaptive) decision trees: decode, tokenize, filtering.

Mirrors modular/encoding/dec_ma.{h,cc} and TokenizeTree (enc_ma.cc:983-1019).
Tree layout: breadth-first; split nodes reference children by index; leaves
carry (context id, predictor, offset, multiplier).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..base.status import JXLError
from ..io.bits import BitReader, BitWriter
from ..io.fields import pack_signed, unpack_signed
from ..entropy.decode import ANSSymbolReader, decode_histograms
from ..entropy.encode import Token, build_and_encode_histograms, write_tokens
from .predict import NUM_PREDICTORS, NUM_STATIC_PROPERTIES

# MATreeContext (ma_common.h:13-22)
K_SPLIT_VAL_CTX = 0
K_PROPERTY_CTX = 1
K_PREDICTOR_CTX = 2
K_OFFSET_CTX = 3
K_MULTIPLIER_LOG_CTX = 4
K_MULTIPLIER_BITS_CTX = 5
NUM_TREE_CONTEXTS = 6
MAX_TREE_SIZE = 1 << 22


@dataclass
class TreeNode:
    """PropertyDecisionNode (dec_ma.h:22-50)."""

    property: int = -1  # -1 = leaf
    splitval: int = 0
    lchild: int = 0  # for leaves: context id
    rchild: int = 0
    predictor: int = 0
    predictor_offset: int = 0
    multiplier: int = 1


# `property` the field name shadows the builtin inside the class body, so
# attach accessors after the fact.
TreeNode.is_leaf = property(lambda self: self.property == -1)
TreeNode.context = property(lambda self: self.lchild)

Tree = list  # list[TreeNode]


def make_fixed_tree(predictor: int, offset: int = 0,
                    multiplier: int = 1) -> Tree:
    """Single-leaf tree: one context, one predictor."""
    return [TreeNode(-1, 0, 0, 0, predictor, offset, multiplier)]


def num_tree_contexts(tree: Tree) -> int:
    return (len(tree) + 1) // 2


def decode_tree_tokens(r: BitReader, reader: ANSSymbolReader, context_map,
                       tree_size_limit: int) -> Tree:
    """dec_ma.cc:42-92."""
    tree: Tree = []
    leaf_id = 0
    to_decode = 1
    while to_decode > 0:
        if len(tree) > tree_size_limit:
            raise JXLError("tree too large")
        to_decode -= 1
        prop1 = reader.read_hybrid_uint(K_PROPERTY_CTX, r, context_map)
        if prop1 > 256:
            raise JXLError("invalid tree property value")
        prop = prop1 - 1
        if prop == -1:
            predictor = reader.read_hybrid_uint(K_PREDICTOR_CTX, r, context_map)
            if predictor >= NUM_PREDICTORS:
                raise JXLError("invalid predictor")
            offset = unpack_signed(
                reader.read_hybrid_uint(K_OFFSET_CTX, r, context_map))
            mul_log = reader.read_hybrid_uint(K_MULTIPLIER_LOG_CTX, r, context_map)
            if mul_log >= 31:
                raise JXLError("invalid multiplier log")
            mul_bits = reader.read_hybrid_uint(K_MULTIPLIER_BITS_CTX, r, context_map)
            if mul_bits >= (1 << (31 - mul_log)) - 1:
                raise JXLError("invalid multiplier")
            multiplier = (mul_bits + 1) << mul_log
            tree.append(TreeNode(-1, 0, leaf_id, 0, predictor, offset,
                                 multiplier))
            leaf_id += 1
            continue
        splitval = unpack_signed(
            reader.read_hybrid_uint(K_SPLIT_VAL_CTX, r, context_map))
        tree.append(TreeNode(prop, splitval,
                             len(tree) + to_decode + 1,
                             len(tree) + to_decode + 2, 0, 0, 1))
        to_decode += 2
    _validate_tree(tree)
    return tree


def _validate_tree(tree: Tree) -> None:
    """dec_ma.cc:22-40 (iterative to avoid recursion limits)."""
    INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
    stack = [(0, {})]  # (node, {prop: (lo, hi)})
    while stack:
        root, bounds = stack.pop()
        node = tree[root]
        if node.is_leaf:
            continue
        lo, hi = bounds.get(node.property, (INT_MIN, INT_MAX))
        if lo > node.splitval or hi <= node.splitval:
            raise JXLError("invalid tree")
        lb = dict(bounds)
        lb[node.property] = (node.splitval + 1, hi)
        rb = dict(bounds)
        rb[node.property] = (lo, node.splitval)
        stack.append((node.lchild, lb))
        stack.append((node.rchild, rb))


def decode_tree(r: BitReader, tree_size_limit: int = MAX_TREE_SIZE) -> Tree:
    """dec_ma.cc:95-113."""
    code, context_map = decode_histograms(r, NUM_TREE_CONTEXTS)
    if code.degenerate_symbols[context_map[K_PROPERTY_CTX]] > 0:
        raise JXLError("infinite tree")
    reader = ANSSymbolReader(code, r)
    tree = decode_tree_tokens(r, reader, context_map,
                              min(tree_size_limit, MAX_TREE_SIZE))
    if not reader.check_final_state():
        raise JXLError("invalid tree ANS stream")
    return tree


def tokenize_tree(tree: Tree):
    """TokenizeTree (enc_ma.cc:983-1019). Returns (tokens, decoder_tree) —
    the BFS-reordered tree the decoder will reconstruct."""
    if len(tree) > MAX_TREE_SIZE:
        raise JXLError("tree too large")
    tokens = []
    decoder_tree: Tree = []
    queue = [0]
    leaf_id = 0
    while queue:
        cur = queue.pop(0)
        node = tree[cur]
        tokens.append(Token(K_PROPERTY_CTX, node.property + 1))
        if node.is_leaf:
            tokens.append(Token(K_PREDICTOR_CTX, node.predictor))
            tokens.append(Token(K_OFFSET_CTX, pack_signed(node.predictor_offset)))
            mul_log = (node.multiplier & -node.multiplier).bit_length() - 1
            mul_bits = (node.multiplier >> mul_log) - 1
            tokens.append(Token(K_MULTIPLIER_LOG_CTX, mul_log))
            tokens.append(Token(K_MULTIPLIER_BITS_CTX, mul_bits))
            decoder_tree.append(TreeNode(-1, 0, leaf_id, 0, node.predictor,
                                         node.predictor_offset, node.multiplier))
            leaf_id += 1
            continue
        decoder_tree.append(TreeNode(
            node.property, node.splitval,
            len(decoder_tree) + len(queue) + 1,
            len(decoder_tree) + len(queue) + 2, 0, 0, 1))
        queue.append(node.lchild)
        queue.append(node.rchild)
        tokens.append(Token(K_SPLIT_VAL_CTX, pack_signed(node.splitval)))
    return tokens, decoder_tree


def encode_tree(tree: Tree, w: BitWriter):
    """EncodeTree: tokenize + histograms + tokens. Returns decoder_tree."""
    tokens, decoder_tree = tokenize_tree(tree)
    codes, context_map = build_and_encode_histograms(
        [tokens], NUM_TREE_CONTEXTS, w)
    write_tokens(tokens, codes, context_map, w)
    return decoder_tree


def filter_tree(tree: Tree, static_props):
    """Specialize the tree for (channel, group) static properties and report
    usage flags (simplified FilterTree, encoding.cc:37-139: we prune static
    branches but keep the plain child-pointer layout).

    Returns (pruned tree in original layout with static branches resolved,
    uses_wp, max_property).
    """

    def resolve(idx):
        node = tree[idx]
        while not node.is_leaf and node.property < NUM_STATIC_PROPERTIES:
            if static_props[node.property] > node.splitval:
                idx = node.lchild
            else:
                idx = node.rchild
            node = tree[idx]
        return idx

    uses_wp = False
    max_prop = 0
    new_nodes = []
    index_map = {}
    worklist = [resolve(0)]
    while worklist:
        idx = worklist.pop()
        if idx in index_map:
            continue
        index_map[idx] = len(new_nodes)
        node = tree[idx]
        new_nodes.append(node)
        if node.is_leaf:
            if node.predictor == 6:  # Weighted
                uses_wp = True
        else:
            max_prop = max(max_prop, node.property)
            from .predict import WP_PROP

            if node.property == WP_PROP:
                uses_wp = True
            worklist.append(resolve(node.lchild))
            worklist.append(resolve(node.rchild))
    # remap child pointers
    out = []
    for idx, new_idx in sorted(index_map.items(), key=lambda kv: kv[1]):
        node = tree[idx]
        if node.is_leaf:
            out.append(node)
        else:
            out.append(TreeNode(node.property, node.splitval,
                                index_map[resolve(node.lchild)],
                                index_map[resolve(node.rchild)],
                                0, 0, 1))
    return out, uses_wp, max_prop

