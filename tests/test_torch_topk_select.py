"""K_s's select, step by step, on the CPU: an emulation of what
`csrc/topk_fwd.cu::select_kernel` does, held bit for bit to the plain
select (`topk_kernel._select_plain`, a sort of the ordered keys).

The kernel gives each (member, row) a block of 128 threads. Thread t holds
16-byte chunks t, t + 128, ... of a piece of the row (8 keys a chunk, a
piece as long as the registers hold: `_chunks`), each key's high and low
ordered byte as the fp16 integer 1024 + byte, two keys a word; keys past
the row are 0 and never count. The high byte is found by bisection, its bit
7 first, after one pass finds the row's largest high byte (an fp16 max): a
candidate above it counts 0 without a pass; for the others every thread
adds sat((1024 + byte) - (1023 + c)) over its words into four fp16
accumulators (word e of each chunk into the e-th, the first from 1024) and
reads n from the bits of their sum 1024 + n in both halves; one integer
reduction sums a warp, then the 4 warps are summed in order. The candidate
is kept when the count reaches k (clamped to [1, N]); the count of the
last refused candidate is the count above the byte found. The low byte is
bisected the same way among the keys whose high byte is the one found (the
others' low bytes set to 0), against k less that count. A row longer than
a piece is counted piece by piece on every pass. Every sum is an integer
below 2048 while in fp16, so exact: the emulation asserts it, then reads
the key back as the kernel does.

Rows: ties straddling a high-byte boundary, k = 1, N, > N and <= 0, all
negative, zeros of both signs, one repeated value, the k-th value in the
most crowded high byte, NaN, random rows at BASELINE config 4's N (12288)
and a row counted in three pieces (N 40960). Exact: no tolerance.
"""

import pytest
import torch

from _torch_select_rows import CASES, case
from sparse_coding__tpu_torch.ops import topk_kernel as kk

THREADS, WARPS = 128, 4
CHUNK_KEYS = 8
CHUNKS = (1, 2, 3, 4, 6, 8, 12, 16)  # the kernel's instantiations: chunks a thread holds
PAD = -1024  # a key past the row: fp16 0 = 1024 + PAD, never >= 1024 + c


def _chunks(n: int) -> int:
    per_thread = -(-(n // CHUNK_KEYS) // THREADS)
    return next((c for c in CHUNKS if per_thread <= c), CHUNKS[-1])


def _thread_counts(byte: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """One piece [R, kc * 128 * 8] of bytes (PAD past the row) -> each
    thread's count [R, 128] of bytes >= cand [R], summed as the kernel sums
    it: fp16 terms into four fp16 accumulators (word e of each chunk into
    the e-th), the first from 1024, then their sum 1024 + n read back from
    its bits (0x6400 + n) in both halves."""
    R, L = byte.shape
    kc = L // (THREADS * CHUNK_KEYS)
    # [R, chunk c, thread t, word e, half] <- key ((c * 128 + t) * 8 + 2 e + half)
    v = (1024 + byte).reshape(R, kc, THREADS, 4, 2).to(torch.float16)
    c2 = (1023 + cand).to(torch.float16).view(R, 1, 1, 1, 1)
    term = (v - c2).clamp(0, 1)  # __hsub2_sat: exact, both sides integers below 2048
    a = [torch.full((R, THREADS, 2), 1024.0 if e == 0 else 0.0, dtype=torch.float16) for e in range(4)]
    for c in range(kc):
        for e in range(4):
            a[e] = a[e] + term[:, c, :, e]
    both = (a[0] + a[1]) + (a[2] + a[3])
    assert bool((both < 2048).all()), "an fp16 count left the exact integers"
    n = both.view(torch.int16).to(torch.int64) - 0x6400
    return n[..., 0] + n[..., 1]


def _block_count(byte: torch.Tensor, cand: torch.Tensor, piece: int) -> torch.Tensor:
    """The block's count [R] of bytes >= cand over the row, piece by piece:
    a thread's pieces summed as integers, a warp's 32 lanes by one
    `__reduce_add_sync`, then the 4 warps' sums in order."""
    R, L = byte.shape
    n = torch.zeros((R, THREADS), dtype=torch.int64)
    for p0 in range(0, L, piece):
        n = n + _thread_counts(byte[:, p0:p0 + piece], cand)
    warps = n.view(R, WARPS, 32).sum(-1)
    total = torch.zeros(R, dtype=torch.int64)
    for w in range(WARPS):
        total = total + warps[:, w]
    return total


def _emulate_select(s: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """select_kernel's steps on s [M, B, N] bf16, k [M] -> thresh [M, B] f32."""
    M, B, N = s.shape
    keys = kk._ordered(s).reshape(M * B, N)
    need = k.to(torch.int64).clamp(1, N).repeat_interleave(B)
    piece = _chunks(N) * THREADS * CHUNK_KEYS
    L = -(-N // piece) * piece
    pad = torch.full((M * B, L - N), PAD, dtype=torch.int32)
    hi_b = torch.cat([keys >> 8, pad], 1)
    lo_b = torch.cat([keys & 0xFF, pad], 1)
    rows = M * B
    # the row's largest high byte: an fp16 max of 1024 + byte read back from
    # its bits; a candidate above it counts 0 without a pass
    fp = torch.where(hi_b == PAD, 0, 1024 + hi_b).to(torch.float16)
    top = fp.max(dim=1).values.view(torch.int16).to(torch.int64) - 0x6400
    hi = torch.zeros(rows, dtype=torch.int32)
    above = torch.zeros(rows, dtype=torch.int64)
    for bit in range(7, -1, -1):
        cand = hi | (1 << bit)
        n = torch.where(cand > top, 0, _block_count(hi_b, cand, piece))
        ok = n >= need
        above = torch.where(ok, above, n)
        hi = torch.where(ok, cand, hi)
    lo_b = torch.where(hi_b == hi[:, None], lo_b, PAD)  # in_bin: fp16 0 outside the byte found
    need_lo = need - above
    lo = torch.zeros(rows, dtype=torch.int32)
    for bit in range(7, -1, -1):
        cand = lo | (1 << bit)
        lo = torch.where(_block_count(lo_b, cand, piece) >= need_lo, cand, lo)
    return kk._unordered((hi << 8) | lo).float().view(M, B)


@pytest.mark.parametrize("name", CASES)
def test_select_emulation_is_bit_equal_to_the_plain_select(name):
    s, k = case(name)
    got = _emulate_select(s, k)
    want = kk._select_plain(s, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name


@pytest.mark.parametrize("n, chunks", [(128, 1), (1024, 1), (1152, 2), (6144, 6), (12288, 12), (12416, 16),
                                       (40960, 16)])
def test_select_chunks_cover_the_row(n, chunks):
    """The kernel's choice of chunks a thread holds (`select_chunks`): the
    fewest instantiation that holds the row, else 16 with the row in pieces."""
    assert _chunks(n) == chunks
    assert chunks * THREADS * CHUNK_KEYS >= n or chunks == CHUNKS[-1]
