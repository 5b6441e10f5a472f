"""The serving engine's CUDA-graph route on the card. Needs an NVIDIA GPU;
skips (inside each test) without one. On the card:

    python -m pytest tests/test_torch_serve_cuda.py -m cuda -q

Each (group, bucket, k-bucket, row dtype) dispatch is a captured graph:
replays equal the eager dispatch and every lane its stack of one, bit for
bit, native and int8, dense and top-k, f32 and f16 rows; a `swap` that
keeps the group's lanes copies the new weights into the captured buffers
(no capture, no request served with the old weights) and a change of
membership captures anew; captures run on the drainer while other threads
use the card; `/features` equals `harvest_to_device` then encode.
"""

import threading

import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch.models.learned_dict import TiedSAE
from sparse_coding__tpu_torch.serve.engine import EncodeEngine, encode_lanes
from sparse_coding__tpu_torch.serve.registry import DictRegistry

pytestmark = pytest.mark.cuda

D, N = 128, 1024


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's dispatches are captured CUDA graphs there")


def _tied(seed: int, n: int = N, dtype=torch.float32) -> TiedSAE:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return TiedSAE((torch.randn(n, D, generator=g, device="cuda") * 0.1).to(dtype),
                   (torch.randn(n, generator=g, device="cuda") * 0.01).to(dtype))


def _rows(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a.view(torch.int16), b.view(torch.int16)) if a.dtype == torch.bfloat16 else torch.equal(a, b)
    return np.array_equal(a, b)


@pytest.mark.parametrize("weights", ["native", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_graph_replays_equal_eager_and_lanes_equal_stacks_of_one(weights, dtype):
    _need_cuda()
    reg = DictRegistry()
    for i in range(6):
        reg.add(f"d{i}", _tied(i), weights=weights)
    eng = EncodeEngine(reg, max_batch=256).start()
    try:
        eng.warmup(topk_ks=(16,), dtypes=(dtype,))
        warm = eng.captures
        assert warm == 2 * len(eng.buckets) + (weights == "int8")
        for n in (1, 7, 8, 9, 100, 256):
            rows = _rows(n, n).astype(dtype)
            for k in (None, 5, 16):
                for did in ("d0", "d5"):
                    r = eng.compare_routes(did, rows, top_k=k)
                    assert _same(r["graph"], r["eager"]) and _same(r["graph"], r["naive"]), (n, k, did)
        assert eng.captures == warm
    finally:
        eng.stop()


def test_swap_copies_into_the_captured_group_and_membership_recaptures():
    _need_cuda()
    reg = DictRegistry()
    for i in range(4):
        reg.add(f"d{i}", _tied(i))
    eng = EncodeEngine(reg, max_batch=64).start()
    try:
        eng.warmup()
        warm = eng.captures
        X = _rows(1, 20)
        before = eng.encode("d1", X)
        new = _tied(99)
        reg.swap("d1", new)
        after = eng.encode("d1", X)
        assert eng.captures == warm  # same lanes: weights copied in place, graphs replayed
        assert not np.array_equal(before, after)
        assert np.array_equal(after, eng.encode_naive("d1", X))
        torch.testing.assert_close(torch.from_numpy(after), new.encode(torch.from_numpy(X).cuda()).cpu(),
                                   rtol=1e-6, atol=1e-6)
        # concurrent swaps under load: every response is one of the two
        # dicts' codes, and after the last swap only the new one's
        olds = {i: eng.encode_naive(f"d{i}", X) for i in range(4)}
        stop = threading.Event()
        seen = []

        def client():
            while not stop.is_set():
                seen.append(eng.encode("d2", X))

        t = threading.Thread(target=client)
        t.start()
        repl = _tied(123)
        for j in range(5):
            reg.swap("d2", repl if j % 2 == 0 else _tied(2))
        reg.swap("d2", repl)
        stop.set()
        t.join()
        final = eng.encode("d2", X)
        assert np.array_equal(final, eng.encode_naive("d2", X)) and not np.array_equal(final, olds[2])
        assert eng.captures == warm
        # a new member changes the lanes: the group is captured anew
        reg.add("d4", _tied(4))
        out = eng.encode("d4", X)
        assert eng.captures > warm and np.array_equal(out, eng.encode_naive("d4", X))
    finally:
        eng.stop()


def test_features_equal_harvest_then_encode_on_the_card():
    _need_cuda()
    from sparse_coding__tpu_torch.data.activations import harvest_to_device
    from sparse_coding__tpu_torch.lm import model as tm

    cfg = tm.LMConfig(arch="neox", n_layers=2, d_model=D, n_heads=4, d_mlp=4 * D, vocab_size=512, n_ctx=64,
                      rotary_pct=0.25)
    reg = DictRegistry()
    reg.add("f0", _tied(3))
    reg.attach_subject("s", tm.init_params(0, cfg), cfg, 1)
    eng = EncodeEngine(reg, max_batch=256).start()
    try:
        eng.warmup_features(32, topk_ks=(8,))
        warm = eng.captures
        for s in (1, 2, 4, 8):
            toks = np.random.default_rng(s).integers(0, 512, (s, 32)).astype(np.int32)
            fused = eng.encode_features("f0", toks)
            (chunk,) = harvest_to_device(reg.get_subject().params, cfg, toks, [1], ["residual"], batch_size=s,
                                         chunk_size_gb=s * 32 * D * 2 / 1024**3, n_chunks=1)
            assert np.array_equal(fused, eng.features_naive("f0", toks))
            assert np.array_equal(fused, encode_lanes([reg.get("f0").ld], chunk[(1, "residual")])[0].cpu().numpy())
            idx, vals = eng.encode_features("f0", toks, top_k=8)
            assert np.array_equal(vals, np.take_along_axis(fused, idx.astype(np.int64), axis=1))
        assert eng.captures == warm
    finally:
        eng.stop()
