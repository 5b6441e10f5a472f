"""The shapes the dense K2/K3 take, as the Python side states them, on the CPU.

`shapes_supported` is the one shape predicate of the tied-SAE kernels: it
must take every (N, D, B) it took before the wgmma mainloop (the WMMA
mainloop's dictionary tiles: 256 rows at D 128, 128 at 256, 64 at 512, 32
at 768 and 1024). The wgmma mainloop now runs D 128, 256, 512 and 1024
(at 1024 128 rows shared by a cluster of four blocks, on the stored code
and rebuilding it); D 768 keeps the WMMA mainloop. The tiles and
shared-memory plans of the dense route live in the CUDA source alone
(`ops/csrc/tied_sae_bwd.cuh`), which asserts at compile time that each
block's (or cluster's) rows divide K1's 128-column tile.
"""

import pytest

from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.ops._wrap import FWD_COLS, FWD_ROWS

# the dictionary rows of a dense block before the wgmma mainloop, by width
OLD_TILE = {128: 256, 256: 128, 512: 64, 768: 32, 1024: 32}


def _old_supported(n: int, d: int, b: int) -> bool:
    return d in OLD_TILE and n % FWD_COLS == 0 and n % OLD_TILE[d] == 0 and b % FWD_ROWS == 0


@pytest.mark.parametrize("d", sorted(OLD_TILE))
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 32, 96])
def test_shapes_supported_takes_every_shape_it_took_before(d, k):
    """N at k multiples of the old predicate's step, B at several multiples
    of K1's 64-row tile: all still taken."""
    step = max(FWD_COLS, OLD_TILE[d])
    for b in (64, 128, 320, 2048, 4096):
        assert _old_supported(k * step, d, b)
        assert tk.shapes_supported(k * step, d, b), (k * step, d, b)
        assert tk.shapes_supported(k * step, d)


@pytest.mark.parametrize("d", sorted(OLD_TILE))
def test_shapes_supported_refuses_ragged_shapes(d):
    """N off K1's 128-column tile, B off its 64-row tile, or a width the
    kernels are not written for: refused (the wrappers raise before a
    launch)."""
    assert tk.shapes_supported(4096, d, 2048)
    assert not tk.shapes_supported(FWD_COLS * 3 + 64, d)
    assert not tk.shapes_supported(4096, d, 2048 + 32)
    assert not tk.shapes_supported(4096, d + 64)
