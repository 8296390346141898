"""HuffmanTree inspector vs the reference's tree.rs unit-test expectations."""

import numpy as np
import pytest

from dmmt_jpeg_encoder.huffman.tree import (
    INNER,
    LEAF,
    ONESTAR,
    HuffmanTree,
)

EVEN = [(1, 17), (2, 3), (3, 12), (4, 3), (5, 18), (6, 12)]
ODD = [(1, 17), (2, 3), (3, 12), (4, 3), (5, 18), (6, 12), (7, 13)]


def node_depths(tree):
    """Root depth 1; OneStar counts one deeper (tree.rs test helper)."""
    depths = [0] * len(tree.nodes)
    depths[tree.root_index] = 1
    stack = [tree.root_index]
    while stack:
        i = stack.pop()
        node = tree.nodes[i]
        if node.kind == INNER:
            depths[node.left] = depths[i] + 1
            depths[node.right] = depths[i] + 1
            stack.append(node.left)
            stack.append(node.right)
        elif node.kind == ONESTAR:
            depths[i] += 1
    return depths


def depth_under(tree, index, agg):
    node = tree.nodes[index]
    if node.kind == LEAF:
        return 1
    if node.kind == ONESTAR:
        return 2
    return agg(
        depth_under(tree, node.left, agg), depth_under(tree, node.right, agg)
    ) + 1


def test_depths_even_len():
    tree = HuffmanTree(EVEN, limit=10)
    assert node_depths(tree)[:6] == [5, 5, 4, 3, 3, 3]


def test_depths_odd_len():
    tree = HuffmanTree(ODD, limit=10)
    assert node_depths(tree)[:7] == [5, 5, 4, 4, 4, 3, 3]


def test_depths_after_onestar():
    tree = HuffmanTree(ODD, limit=10)
    tree.replace_onestar()
    assert node_depths(tree)[:7] == [6, 5, 4, 4, 4, 3, 3]


def test_least_frequent_index_is_first_occurrence():
    tree = HuffmanTree(ODD, limit=10)
    assert tree.least_frequent_symbol_node_index == 0
    tree.replace_onestar()
    assert tree.least_frequent_symbol_node_index == 0


def test_max_depth_under_node():
    tree = HuffmanTree(ODD, limit=10)
    assert depth_under(tree, 11, max) == 2
    assert depth_under(tree, 12, max) == 5  # the root
    assert depth_under(tree, 3, max) == 1


def test_node_index_invariant():
    for replace in (False, True):
        tree = HuffmanTree(ODD, limit=10)
        if replace:
            tree.replace_onestar()
        for i, node in enumerate(tree.nodes):
            assert node.index == i


def test_higher_frequency_not_deeper():
    for replace in (False, True):
        tree = HuffmanTree(sorted(ODD, key=lambda p: p[1]), limit=10)
        if replace:
            tree.replace_onestar()
        depths = node_depths(tree)[: tree.leaf_count]
        assert all(a >= b for a, b in zip(depths, depths[1:]))


def test_decode_reference_byte_sequence():
    """Exact bitstream decode parity with tree.rs test_coder_decode."""
    tree = HuffmanTree(ODD, limit=10)
    tree.replace_onestar()
    data = bytes([0b01110111, 0b10111101, 0b00001110, 0b11100100])
    assert tree.decode_sequence(data)[:9] == [1, 3, 2, 2, 7, 5, 4, 4, 1]


def test_right_subtree_at_least_as_deep():
    tree = HuffmanTree([(1, 4), (2, 4), (3, 6), (4, 6), (5, 7), (6, 9)], limit=10)
    for node in tree.nodes:
        if node.kind == INNER:
            assert depth_under(tree, node.right, min) >= depth_under(
                tree, node.left, max
            )


def test_display_renders_all_leaves():
    tree = HuffmanTree(EVEN, limit=10)
    art = str(tree)
    for sym, freq in EVEN:
        assert f"(s:{sym},f:{freq})" in art
    tree.replace_onestar()
    art = str(tree)
    assert "╔╝" in art  # the OneStar box
