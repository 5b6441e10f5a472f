"""Crafted score rows for K_s's select, shared by its CPU emulation test
(tests/test_torch_topk_select.py) and its CUDA test
(tests/test_torch_kernels_cuda.py): each case is (s [M, B, N] bf16, k [M]
int32), made from a seed with numpy."""

import numpy as np
import torch

from sparse_coding__tpu_torch.ops import topk_kernel as kk


def from_keys(keys) -> torch.Tensor:
    return kk._unordered(torch.as_tensor(np.asarray(keys), dtype=torch.int32))


def bf16(vals) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.float32).to(torch.bfloat16)


def case(name: str):
    """(s [M, B, N] bf16, k [M]) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    N = 512
    if name == "ties_straddle_a_byte_boundary":
        # keys 0xC0FF and 0xC100 sit on either side of a high-byte boundary;
        # k lands inside each tie group and on its edges
        base = rng.integers(0x4000, 0xC000, size=N)
        base[:9] = 0xC100
        base[9:20] = 0xC0FF
        row = from_keys(base)
        s = row.expand(6, 1, N).contiguous()
        return s, torch.tensor([1, 9, 10, 19, 20, 21], dtype=torch.int32)
    if name == "k_clamps":
        s = bf16(rng.standard_normal((4, 2, N)))
        return s, torch.tensor([1, N, N + 77, 0], dtype=torch.int32)
    if name == "k_negative":
        s = bf16(rng.standard_normal((2, 2, N)))
        return s, torch.tensor([-3, -(1 << 30)], dtype=torch.int32)
    if name == "all_negative":
        s = bf16(-np.abs(rng.standard_normal((3, 2, N))) - 1e-3)
        return s, torch.tensor([1, 40, N], dtype=torch.int32)
    if name == "zeros_of_both_signs":
        vals = np.zeros((3, 2, N), np.float32)
        vals[..., : N // 2] = -0.0
        vals[..., N // 2: N // 2 + 5] = -1.0
        vals[..., -3:] = 2.0
        s = bf16(vals)
        return s, torch.tensor([3, 4, N // 2 + 3], dtype=torch.int32)
    if name == "one_repeated_value":
        s = torch.full((3, 2, N), 0.375).to(torch.bfloat16)
        return s, torch.tensor([1, 200, N], dtype=torch.int32)
    if name == "kth_in_the_most_crowded_high_byte":
        s = bf16(rng.standard_normal((1, 4, N)))
        hib = (kk._ordered(s[0, 0]) >> 8).numpy()
        crowded = np.bincount(hib, minlength=256).argmax()
        order = np.sort(hib)[::-1]
        first = int(np.argmax(order == crowded))  # rank (0-based) of its largest key
        count = int((order == crowded).sum())
        return s.expand(3, 4, N).contiguous(), torch.tensor(
            [first + 1, first + count // 2, first + count], dtype=torch.int32)
    if name == "nan_scores":
        vals = rng.standard_normal((2, 2, N)).astype(np.float32)
        vals[0, 0, :5] = np.nan
        vals[1, 1, 7] = -np.nan
        return bf16(vals), torch.tensor([3, 6], dtype=torch.int32)
    if name == "random_rows_config4":
        s = bf16(rng.standard_normal((7, 3, 12288)))
        return s, torch.tensor([1, 11, 31, 61, 91, 121, 151], dtype=torch.int32)
    if name == "a_row_longer_than_a_piece":
        N = 40960  # three pieces of 16384 keys, the last ragged
        s = bf16(rng.standard_normal((2, 2, N)))
        s[1, 0, -100:] = 9.0  # the top keys in the second piece
        return s, torch.tensor([37, 120], dtype=torch.int32)
    raise KeyError(name)


CASES = ["ties_straddle_a_byte_boundary", "k_clamps", "k_negative", "all_negative", "zeros_of_both_signs",
         "one_repeated_value", "kth_in_the_most_crowded_high_byte", "nan_scores", "random_rows_config4",
         "a_row_longer_than_a_piece"]
