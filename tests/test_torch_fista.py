"""The port's FISTA math and its solve kernel's plain version against the
JAX package, on the same numpy inputs (CPU).

Tolerances, and why:
  - the momentum table: bit for bit (float32 on both sides, the same
    operations in the same order);
  - λmax by power iteration: rtol 1e-6 (the two frameworks sum the matvecs
    in another order; 1e-7 measured);
  - codes and residuals of the plain loop against JAX's `fista`: atol 1e-5
    (3e-6 measured over 100 iterations at these shapes — each product sums
    in another order, which FISTA carries from one iteration to the next);
    against the Pallas kernels in interpret mode, the JAX suite's own pins
    (`tests/test_pallas_ops.py`): atol 1e-4 for `fista_pallas` and 1e-5 for
    `fista_pallas_hbm_dict`;
  - the early exit: the same iteration count as JAX's loop, shown by JAX's
    fixed-count solve equal to its tol solve at that count and not one
    before;
  - basis and dictionary updates: atol 1e-6 (unit-norm rows; one update
    sums each product once).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu_torch.models import fista as tf
from sparse_coding__tpu_torch.ops import fista_kernel as fk

jf = importlib.import_module("sparse_coding__tpu.models.fista")
jp = importlib.import_module("sparse_coding__tpu.ops.fista_pallas")

M, B, N, D = 2, 96, 32, 16  # B deliberately not a multiple of the Pallas batch tiles
L1 = np.array([1e-3, 1e-2], np.float32)


def _planted(seed=0, m=M, b=B, n=N, d=D, prob=0.1, same_dict=False, noise=0.0):
    """Unit-norm dictionaries [m, n, d]; sparse non-negative codes planted in
    the first; the batch x [b, d] they make (plus noise)."""
    rng = np.random.default_rng(seed)
    dicts = rng.standard_normal((m, n, d)).astype(np.float32)
    if same_dict:
        dicts[:] = dicts[0]
    dicts /= np.linalg.norm(dicts, axis=-1, keepdims=True)
    codes = (rng.uniform(0.5, 1.5, (b, n)) * (rng.uniform(size=(b, n)) < prob)).astype(np.float32)
    x = (codes @ dicts[0] + noise * rng.standard_normal((b, d))).astype(np.float32)
    return dicts, x


def _jax_fista(x, dicts, l1, c0, num_iter, tol=0.0):
    out = [jf.fista(jnp.asarray(x), jnp.asarray(dicts[m]), jnp.asarray(l1[m]), jnp.asarray(c0[m]), num_iter, tol=tol)
           for m in range(len(dicts))]
    return np.stack([np.asarray(a) for a, _ in out]), np.stack([np.asarray(r) for _, r in out])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("num_iter", [1, 7, 500])
def test_momentum_table_matches_jax_bit_for_bit(num_iter):
    def body(tk, _):
        tk_n = (1.0 + jnp.sqrt(1.0 + 4.0 * tk**2)) / 2.0
        return tk_n, (tk - 1.0) / tk_n

    _, ref = jax.lax.scan(body, jnp.asarray(1.0, jnp.float32), None, length=num_iter)
    got = tf.momentum_table(num_iter)
    assert got.dtype == np.float32 and got[0] == 0.0
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(ref).view(np.uint32))


def test_power_iteration_matches_jax():
    dicts, _ = _planted()
    got = tf.power_iteration_max_eig(_t(dicts), n_iter=50)
    ref = [float(jf.power_iteration_max_eig(jnp.asarray(d), n_iter=50)) for d in dicts]
    np.testing.assert_allclose(to_np(got), ref, rtol=1e-6)
    exact = [np.linalg.eigvalsh(d.astype(np.float64) @ d.T.astype(np.float64)).max() for d in dicts]
    np.testing.assert_allclose(to_np(got), exact, rtol=1e-3)
    np.testing.assert_allclose(to_np(tf.default_eta(_t(dicts))), 1.0 / (1.05 * np.asarray(ref)), rtol=1e-6)


@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("start", ["zeros", "warm"])
def test_plain_fista_matches_jax(tol, start):
    dicts, x = _planted()
    c0 = np.zeros((M, B, N), np.float32)
    if start == "warm":
        c0 = np.abs(np.random.default_rng(3).standard_normal((M, B, N))).astype(np.float32) * 0.2
    ref_a, ref_r = _jax_fista(x, dicts, L1, c0, 100, tol)
    a, r = tf.fista(_t(x), _t(dicts), _t(L1), _t(c0), 100, tol=tol)
    assert a.dtype == torch.float32 and a.shape == (M, B, N) and r.shape == (M, B, D)
    np.testing.assert_allclose(to_np(a), ref_a, rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(r), ref_r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel,atol,tile", [("fista_pallas", 1e-4, 64), ("fista_pallas_hbm_dict", 1e-5, 32)])
@pytest.mark.parametrize("warm", [False, True])
def test_plain_version_matches_the_pallas_kernels(kernel, atol, tile, warm):
    """Rows 8 and 9 of the kernel table run as the JAX suite runs them on the
    CPU (interpret mode, a ragged batch padded to the tile); K_f's plain
    version (`fista_cuda` on CPU tensors) holds to both."""
    dicts, x = _planted(seed=1)
    c0 = (np.abs(np.random.default_rng(4).standard_normal((M, B, N))) * 0.1).astype(np.float32) if warm else None
    for m in range(M):
        ref_a, ref_r = getattr(jp, kernel)(
            jnp.asarray(x), jnp.asarray(dicts[m]), float(L1[m]), num_iter=60,
            coefficients=None if c0 is None else jnp.asarray(c0[m]), batch_tile=tile, interpret=True,
        )
        eta = tf.default_eta(_t(dicts[m : m + 1]))
        a, iters = fk.fista_cuda(_t(x), _t(dicts[m : m + 1]), eta, _t(L1[m : m + 1]),
                                 None if c0 is None else _t(c0[m : m + 1]), 60)
        assert iters.tolist() == [60]
        np.testing.assert_allclose(to_np(a[0]), np.asarray(ref_a), rtol=0, atol=atol)
        res = _t(x) - torch.matmul(a[0], _t(dicts[m]))
        np.testing.assert_allclose(to_np(res), np.asarray(ref_r), rtol=0, atol=atol)


def test_early_exit_takes_jax_loops_iteration_count_per_member():
    """Both members share one dictionary and differ in l1, so each stops at
    its own count (one largest change per member over its whole batch); a
    stopped member keeps its codes while the other goes on."""
    m, b, n, d = 2, 64, 256, 128
    dicts, x = _planted(seed=1, m=m, b=b, n=n, d=d, prob=0.02, same_dict=True, noise=0.01)
    l1 = np.array([1e-3, 3e-3], np.float32)
    c0 = np.zeros((m, b, n), np.float32)
    eta = tf.default_eta(_t(dicts))
    a, iters = tf.fista_codes(_t(x), _t(dicts), eta, _t(l1), _t(c0), 500, tol=1e-3)
    iters = iters.tolist()
    assert all(1 < k < 500 for k in iters) and iters[0] != iters[1], iters
    ref, _ = _jax_fista(x, dicts, l1, c0, 500, tol=1e-3)
    np.testing.assert_allclose(to_np(a), ref, rtol=0, atol=1e-5)
    for i, k in enumerate(iters):
        args = (jnp.asarray(x), jnp.asarray(dicts[i]), jnp.asarray(l1[i]), jnp.asarray(c0[i]))
        at_k, _ = jf.fista(*args, k, tol=1e-3)
        before, _ = jf.fista(*args, k - 1, tol=1e-3)
        assert np.array_equal(np.asarray(at_k), ref[i]), f"member {i}: JAX's loop did not stop at {k}"
        assert not np.array_equal(np.asarray(before), ref[i]), f"member {i}: JAX's loop stopped before {k}"
        # the port's own fixed-count solve at that count gives the same codes
        fixed, _ = tf.fista_codes(_t(x), _t(dicts[i : i + 1]), eta[i : i + 1], _t(l1[i : i + 1]),
                                  _t(c0[i : i + 1]), k)
        assert torch.equal(fixed[0], a[i])


def test_kernel_wrapper_runs_its_plain_version_for_cpu_tensors():
    dicts, x = _planted(seed=2)
    eta = tf.default_eta(_t(dicts))
    fk.reset_launches()
    a, iters = fk.fista_cuda(_t(x), _t(dicts), eta, _t(L1), None, 20)
    ref, _ = tf.fista_codes(_t(x), _t(dicts), eta, _t(L1), torch.zeros(M, B, N), 20)
    assert torch.equal(a, ref) and iters.tolist() == [20, 20]
    assert fk.LAUNCHES == {"fista_solve": 0}


def test_shapes_supported_covers_the_fista_path():
    assert fk.shapes_supported(2048, 2048, 512)  # BASELINE config 3
    assert fk.shapes_supported(256, 512, 128)  # where JAX picks `_fista_kernel`
    assert fk.shapes_supported(96, 32, 16) and fk.shapes_supported(1, 4, 4)  # these tests' shapes
    assert fk.shapes_supported(100_000, 4096, 768)  # any batch: ragged tiles are masked
    assert fk.shapes_supported(96, 30, 16) and fk.shapes_supported(96, 32, 18)  # rows not whole float4s
    assert not fk.shapes_supported(0, 32, 16) and not fk.shapes_supported(128 * 65535 + 1, 32, 16)
    assert not fk.shapes_supported(96, 0, 16) and not fk.shapes_supported(96, 32, 0)


@pytest.mark.parametrize("B,N,D", [(200, 2050, 130), (7, 1, 1), (96, 2048, 511)])
def test_shapes_supported_takes_widths_that_are_not_multiples_of_4(B, N, D):
    """K_f masks the ragged float4 at the row's edge, so the JAX package's
    widths that its Pallas predicates refuse (and its XLA loop trains) reach
    the kernel on the card rather than a refusal."""
    assert fk.shapes_supported(B, N, D)


def test_selector_matches_jax_fista_solve():
    """`fista_solve` with c0 None (zeros) against the JAX selector (which on
    the CPU takes its plain loop); CPU tensors take the plain loop at any
    shape, inside `shapes_supported` or not."""
    dicts, x = _planted(seed=5)
    fk.reset_launches()
    a, r = fk.fista_solve(_t(x), _t(dicts), _t(L1), None, num_iter=40)
    for m in range(M):
        ra, rr = jp.fista_solve(jnp.asarray(x), jnp.asarray(dicts[m]), jnp.asarray(L1[m]), None, num_iter=40)
        np.testing.assert_allclose(to_np(a[m]), np.asarray(ra), rtol=0, atol=1e-5)
        np.testing.assert_allclose(to_np(r[m]), np.asarray(rr), rtol=0, atol=1e-5)
    odd_x, odd = _t(x[:, :15].copy()), _t(dicts[:, :, :15].copy())
    assert fk.shapes_supported(B, N, 15)  # on the card K_f would take it; here the plain loop
    a4, r4 = fk.fista_solve(odd_x, odd, _t(L1), None, num_iter=5)
    ref, ref_r = tf.fista(odd_x, odd, _t(L1), torch.zeros(M, B, N), 5)
    assert torch.equal(a4, ref) and torch.equal(r4, ref_r)
    assert fk.LAUNCHES == {"fista_solve": 0}


def test_quadratic_basis_update_matches_jax():
    dicts, x = _planted(seed=6)
    rng = np.random.default_rng(6)
    ahat = np.abs(rng.standard_normal((M, B, N))).astype(np.float32) * 0.3
    res = rng.standard_normal((M, B, D)).astype(np.float32) * 0.1
    hess = np.abs(rng.standard_normal((M, N))).astype(np.float32) * 0.01
    got = tf.quadratic_basis_update(_t(dicts), _t(res), _t(ahat), 0.001, _t(hess))
    for m in range(M):
        ref = jf.quadratic_basis_update(jnp.asarray(dicts[m]), jnp.asarray(res[m]), jnp.asarray(ahat[m]),
                                        0.001, jnp.asarray(hess[m]))
        np.testing.assert_allclose(to_np(got[m]), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(to_np(got), axis=-1), 1.0, atol=1e-6)


def test_dictionary_update_matches_jax():
    dicts, x = _planted(seed=7)
    rng = np.random.default_rng(7)
    hess = np.abs(rng.standard_normal((M, N))).astype(np.float32) * 0.01
    c0 = np.abs(rng.standard_normal((M, B, N))).astype(np.float32) * 0.1
    got = tf.dictionary_update(_t(dicts), _t(hess), _t(x), _t(c0), _t(L1), num_iter=50)
    for m in range(M):
        ref = jf.dictionary_update(jnp.asarray(dicts[m]), jnp.asarray(hess[m]), jnp.asarray(x),
                                   jnp.asarray(c0[m]), jnp.asarray(L1[m]), num_iter=50)
        for name, g, r in zip(("dict", "hessian", "res"), got, ref):
            np.testing.assert_allclose(to_np(g[m]), np.asarray(r), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", ["early_exit_per_tile", "bf16_batch"])
def test_port_follows_fista_where_the_jax_routes_differ(case):
    """Two places where the JAX package's Pallas route and its plain `fista`
    give different answers (ROADMAP §C); the port follows `fista`:
      - ``tol > 0``: the Pallas kernels stop each batch tile on the tile's
        own largest change, `fista` each member on its whole batch;
      - a bf16 batch: the Pallas wrapper takes η in f32 and returns bf16
        codes, `fista` rounds η to bf16 and returns f32 codes."""
    dicts, x = _planted(seed=1, m=1, b=64, n=256, d=128, prob=0.02, noise=0.01)
    c0 = np.zeros((64, 256), np.float32)
    if case == "early_exit_per_tile":
        kw = dict(num_iter=500, tol=1e-3)
        xj, xt = jnp.asarray(x), _t(x)
        pallas_kw = dict(batch_tile=16)
    else:
        kw = dict(num_iter=100, tol=0.0)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        xt = _t(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
        pallas_kw = dict(batch_tile=64)
    ref, ref_r = jf.fista(xj, jnp.asarray(dicts[0]), jnp.asarray(np.float32(1e-3)), jnp.asarray(c0), kw["num_iter"],
                          tol=kw["tol"])
    got, got_r = tf.fista(xt, _t(dicts), torch.tensor([1e-3]), _t(c0[None]), kw["num_iter"], tol=kw["tol"])
    assert got.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    np.testing.assert_allclose(to_np(got[0]), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(got_r[0]), np.asarray(ref_r).astype(np.float32), rtol=0, atol=1e-5)
    pal, _ = jp.fista_pallas(xj, jnp.asarray(dicts[0]), 1e-3, interpret=True, **kw, **pallas_kw)
    # the JAX package's other route: apart by far more than the port is
    # (5.2e-3 and 3.9e-3 measured)
    assert np.abs(np.asarray(pal).astype(np.float32) - np.asarray(ref)).max() > 1e-3
