"""The port's wire codecs and sparse/dtype serving contracts, held against the
JAX package's `serve/wire.py` on the same numpy inputs.

Payloads are byte-identical to JAX's in every format and dtype (bf16 as a
``torch.bfloat16`` tensor on the port's side, an ml_dtypes array on JAX's),
and each package decodes the other's. The engine's on-device top-k, the
k-bucket menu, the dtype round trip through a live server and the
round-trip contract per dict class follow JAX's `tests/test_wire.py`, case
for case.
"""

import time
import urllib.error
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

from sparse_coding__tpu.serve import wire as jwire
from sparse_coding__tpu_torch.models.learned_dict import IdentityReLU, RandomDict, ReverseSAE, TiedSAE, UntiedSAE
from sparse_coding__tpu_torch.serve import wire
from sparse_coding__tpu_torch.serve.engine import EncodeEngine, k_bucket, topk_stable
from sparse_coding__tpu_torch.serve.registry import DictRegistry
from sparse_coding__tpu_torch.serve.server import ServeServer

pytestmark = pytest.mark.serve

D, N = 16, 64
DTYPES = ["float32", "float16", "bfloat16", "int32", "int8", "float64", "int64", "uint8", "bool"]


def _rows(seed: int, n: int = 5, d: int = D, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(dtype)


def _pair(dtype_name: str, seed: int = 3, shape=(4, 7)):
    """The same array in each package's host form: (JAX's numpy, the port's)."""
    a = np.random.default_rng(seed).standard_normal(shape) * 3
    if dtype_name == "bfloat16":
        j = a.astype(ml_dtypes.bfloat16)
        return j, torch.from_numpy(j.view(np.int16).copy()).view(torch.bfloat16)
    j = (a > 0) if dtype_name == "bool" else a.astype(dtype_name)
    return j, j.copy()


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint8) if x.dtype == torch.bfloat16 else x.numpy().view(np.uint8)
    return np.ascontiguousarray(x).view(np.uint8)


def _dict_of(cls, seed: int = 0, d: int = D, n: int = N):
    rng = np.random.default_rng(seed)
    enc = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1)
    if cls is TiedSAE:
        return TiedSAE(enc, bias)
    if cls is UntiedSAE:
        return UntiedSAE(enc, torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)), bias)
    if cls is ReverseSAE:
        return ReverseSAE(enc, bias)
    if cls is RandomDict:
        return RandomDict(d, n, key=seed, device="cpu")
    if cls is IdentityReLU:
        return IdentityReLU(d, bias=torch.from_numpy(rng.standard_normal(d).astype(np.float32) * 0.1))
    raise AssertionError(cls)


# -- byte identity with the JAX package ------------------------------------------

@pytest.mark.parametrize("fmt", wire.FORMATS)
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_payload_bytes_equal_the_jax_package(monkeypatch, fmt, dtype_name):
    """Same arrays and meta: the same bytes (npz's zip timestamps pinned by
    freezing the clock), and each package decodes the other's bit for bit."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    j, p = _pair(dtype_name)
    meta = {"dict": "d0", "n_rows": 4, "k": 7, "nested": {"a": [1, 2]}}
    jbytes = jwire.encode_payload(fmt, {"codes": j, "aux": np.arange(3, dtype=np.int32)}, meta)
    pbytes = wire.encode_payload(fmt, {"codes": p, "aux": np.arange(3, dtype=np.int32)}, meta)
    assert pbytes == jbytes
    got, got_meta = wire.decode_payload(fmt, jbytes)
    assert got_meta == meta and wire.dtype_name(got["codes"]) == dtype_name
    np.testing.assert_array_equal(_bits(got["codes"]), _bits(j))
    jgot, _ = jwire.decode_payload(fmt, pbytes)
    assert jgot["codes"].dtype == j.dtype
    np.testing.assert_array_equal(_bits(jgot["codes"]), _bits(j))


def test_dtype_codes_and_content_types_are_the_jax_package_s():
    assert wire.DTYPE_CODES == jwire.DTYPE_CODES
    assert wire.CONTENT_TYPES == jwire.CONTENT_TYPES and wire.FORMATS == jwire.FORMATS


# -- codecs (JAX's cases) ----------------------------------------------------------

@pytest.mark.parametrize("fmt", wire.FORMATS)
@pytest.mark.parametrize("dtype_name", ["float32", "float16", "bfloat16", "int32", "int8"])
def test_codec_roundtrip_bit_exact(fmt, dtype_name):
    _, arr = _pair(dtype_name)
    meta = {"dict": "d0", "n_rows": 4, "k": 7, "nested": {"a": [1, 2]}}
    out, out_meta = wire.decode_payload(fmt, wire.encode_payload(fmt, {"codes": arr}, meta))
    assert out_meta == meta
    got = out["codes"]
    assert wire.dtype_name(got) == dtype_name and tuple(got.shape) == tuple(arr.shape)
    np.testing.assert_array_equal(_bits(got), _bits(arr))


@pytest.mark.parametrize("case", ["multiple_arrays", "big_endian", "garbage", "negotiation"])
def test_codec_cases(case):
    if case == "multiple_arrays":
        arrays = {"indices": np.arange(12, dtype=np.int32).reshape(3, 4),
                  "values": np.linspace(0, 1, 12, dtype=np.float16).reshape(3, 4)}
        for fmt in wire.FORMATS:
            out, meta = wire.decode_payload(fmt, wire.encode_payload(fmt, arrays, {}))
            assert meta == {} and set(out) == {"indices", "values"}
            for k in arrays:
                np.testing.assert_array_equal(out[k], arrays[k])
                assert out[k].dtype == arrays[k].dtype
    elif case == "big_endian":
        be = np.array([[1.0, 2.5], [-3.25, 4.0]], dtype=">f4")
        arrays, _ = wire.decode_payload("raw", wire.encode_payload("raw", {"codes": be}, {}))
        np.testing.assert_array_equal(arrays["codes"], be.astype("<f4"))
    elif case == "garbage":
        with pytest.raises(ValueError, match="magic"):
            wire.decode_payload("raw", b"NOPE" + b"\x00" * 32)
        good = wire.encode_payload("raw", {"codes": np.ones((2, 2), np.float32)}, {})
        with pytest.raises(ValueError, match="truncated"):
            wire.decode_payload("raw", good[:-3])
        for fmt, junk in (("raw", b"SCW1\x01\x00"), ("raw", b"SCW1" + b"\xff" * 40), ("npz", b"PK\x03\x04 not a zip"),
                          ("npz", b"total garbage"), ("json", b"{not json")):
            with pytest.raises(ValueError):
                wire.decode_payload(fmt, junk)
    else:
        for accept in (None, "*/*", "application/x-npz", "application/x-sc-raw; q=0.9", "text/html, application/x-npz"):
            assert wire.negotiate(accept) == jwire.negotiate(accept)
        for ct in ("application/json; charset=utf-8", "application/octet-stream", "application/zip", None):
            assert wire.format_of_content_type(ct) == jwire.format_of_content_type(ct)


def test_malformed_binary_body_is_400():
    reg = DictRegistry(device="cpu")
    reg.add("d0", _dict_of(TiedSAE, 0))
    with ServeServer(reg, max_batch=64, max_wait_ms=1.0) as srv:
        req = urllib.request.Request(srv.address + "/encode", data=b"SCW1\x01\x00",
                                     headers={"Content-Type": wire.CONTENT_TYPES["raw"]}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400 and b"bad request" in ei.value.read()


# -- top-k --------------------------------------------------------------------------

def test_k_bucket_menu():
    from sparse_coding__tpu.serve.engine import k_bucket as jk

    for k, n in ((1, 64), (9, 64), (16, 64), (1000, 64), (-3, 64), (33, 40)):
        assert k_bucket(k, n) == jk(k, n)


def test_topk_stable_orders_ties_as_lax_top_k():
    """Ties (every zero after the ReLU is one) come lower index first, -0.0
    below +0.0 and negatives below both, as `lax.top_k` orders them."""
    import jax

    c = np.array([[0.0, 2.0, 0.0, -0.0, 2.0, 1.0, -1.0, 0.0],
                  [-3.0, -1.0, -1.0, -2.0, 0.0, 0.0, 5.0, -0.0]], np.float32)
    for k in (1, 3, 5, 8):
        idx, vals = topk_stable(torch.from_numpy(c), k)
        jv, ji = jax.lax.top_k(c, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.fixture()
def engine1():
    reg = DictRegistry(device="cpu")
    reg.add("d0", _dict_of(TiedSAE, 0))
    eng = EncodeEngine(reg, max_batch=64, max_wait_ms=1.0).start()
    yield reg, eng
    eng.stop()


def test_topk_bit_matches_dense(engine1):
    _, eng = engine1
    X = _rows(0, n=7)
    dense = eng.encode("d0", X)
    idx, vals = eng.encode_topk("d0", X, k=9)
    assert idx.shape == (7, 9) and idx.dtype == np.int32 and vals.dtype == dense.dtype
    for r in range(7):
        np.testing.assert_array_equal(vals[r], dense[r][idx[r]])
        np.testing.assert_array_equal(np.sort(idx[r]), np.sort(np.argsort(-dense[r], kind="stable")[:9]))
        assert (np.diff(vals[r]) <= 0).all()
    nidx, nvals = eng.encode_naive("d0", X, top_k=9)
    np.testing.assert_array_equal(nidx, idx)
    np.testing.assert_array_equal(nvals, vals)


@pytest.mark.parametrize("case", ["clamps_to_n_feats", "menu_bounded", "warmed_bucket_covers", "coalesce_separately",
                                  "dtype_programs"])
def test_topk_engine_cases(engine1, case):
    _, eng = engine1
    if case == "clamps_to_n_feats":
        X = _rows(1, n=2)
        idx, vals = eng.encode_topk("d0", X, k=10_000)
        assert idx.shape == (2, N)
        dense = eng.encode("d0", X)
        for r in range(2):
            np.testing.assert_array_equal(vals[r], dense[r][idx[r]])
    elif case == "menu_bounded":
        eng.warmup(topk_ks=(1, 2, 4, 8, 16, 32, 64))
        warm = set(eng.compiled_shapes)
        for k in (1, 2, 3, 5, 7, 9, 15, 17, 30, 33, 63, 64):
            eng.encode_topk("d0", _rows(k, n=3), k=k)
        assert set(eng.compiled_shapes) == warm
    elif case == "warmed_bucket_covers":
        # warming one k covers every smaller k: it dispatches at that bucket
        eng.warmup(topk_ks=(32,))
        warm = set(eng.compiled_shapes)
        for k in (1, 3, 9, 17, 32):
            idx, vals = eng.encode_topk("d0", _rows(k, n=5), k=k)
            assert idx.shape == (5, k)
        assert set(eng.compiled_shapes) == warm
    elif case == "coalesce_separately":
        X = _rows(2, n=3)
        reqs = [eng.submit("d0", X) for _ in range(2)]
        sreqs = [eng.submit("d0", X, top_k=5) for _ in range(2)]
        dense = [r.result(30) for r in reqs]
        for out in dense:
            np.testing.assert_array_equal(out, dense[0])
        for r in sreqs:
            idx, vals = r.result(30)
            for i in range(3):
                np.testing.assert_array_equal(vals[i], dense[0][i][idx[i]])
    else:
        before = len(eng.compiled_shapes)
        eng.encode("d0", _rows(0, n=3))
        mid = len(eng.compiled_shapes)
        eng.encode("d0", _rows(0, n=3).astype(np.float16))
        assert len(eng.compiled_shapes) > mid >= before + 1


# -- dtype round trip and the round-trip contract through a live server -------------

@pytest.mark.parametrize("fmt", wire.FORMATS)
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16"])
def test_dtype_roundtrips_through_every_format(fmt, dtype_name):
    dt = getattr(torch, dtype_name)
    rng = np.random.default_rng(0)
    ld = TiedSAE(torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(dt), torch.zeros(N, dtype=dt))
    reg = DictRegistry(device="cpu")
    reg.add("q0", ld)
    with ServeServer(reg, max_batch=64, max_wait_ms=1.0) as srv:
        client = srv.client()
        X = torch.from_numpy(_rows(5, n=4)).to(dt)
        direct = ld.encode(X)
        assert direct.dtype == dt
        out = client.encode("q0", X, format=fmt)
        assert wire.dtype_name(out) == dtype_name
        np.testing.assert_array_equal(_bits(out), _bits(direct))
        idx, vals = client.encode("q0", X, format=fmt, top_k=6)
        assert wire.dtype_name(vals) == dtype_name and idx.dtype == np.int32
        dense = torch.as_tensor(np.asarray(direct.float()))
        for r in range(4):
            np.testing.assert_array_equal(np.asarray(torch.as_tensor(vals[r]).float()), dense[r][idx[r]].numpy())


@pytest.fixture(scope="module")
def contract_server():
    classes = [TiedSAE, UntiedSAE, ReverseSAE, RandomDict, IdentityReLU]
    reg = DictRegistry(device="cpu")
    lds = {}
    for i, cls in enumerate(classes):
        lds[cls.__name__] = ld = _dict_of(cls, i)
        reg.add(cls.__name__, ld)
    srv = ServeServer(reg, max_batch=128, max_wait_ms=1.0).start()
    yield srv, lds
    srv.stop()


@pytest.mark.parametrize("fmt", wire.FORMATS)
@pytest.mark.parametrize("cls_name", ["TiedSAE", "UntiedSAE", "ReverseSAE", "RandomDict", "IdentityReLU"])
def test_roundtrip_contract(contract_server, fmt, cls_name):
    """Dense codes over the wire equal the stack-of-one dispatch at the
    response's bucket bit for bit and the raw encode within 1e-6; sparse
    responses are bit-exact slices of the dense codes."""
    srv, lds = contract_server
    client = srv.client()
    X = _rows(11, n=6)
    dense = client.encode(cls_name, X, format=fmt)
    bucket = client.last_meta["bucket"]
    np.testing.assert_array_equal(dense, srv.engine.encode_naive(cls_name, X, bucket=bucket))
    np.testing.assert_allclose(dense, lds[cls_name].encode(torch.from_numpy(X)).numpy(), rtol=1e-6, atol=1e-6)
    k = min(9, dense.shape[1])
    idx, vals = client.encode(cls_name, X, format=fmt, top_k=k)
    assert idx.shape == (6, k)
    for r in range(6):
        np.testing.assert_array_equal(vals[r], dense[r][idx[r]])
        assert (np.diff(vals[r]) <= 0).all()


def test_wire_stats_key_bytes_in_by_request_format():
    reg = DictRegistry(device="cpu")
    reg.add("d0", _dict_of(TiedSAE, 0))
    with ServeServer(reg, max_batch=64, max_wait_ms=1.0) as srv:
        body = wire.encode_payload("raw", {"rows": _rows(1, n=2)}, {"dict": "d0"})
        req = urllib.request.Request(srv.address + "/encode", data=body,
                                     headers={"Content-Type": wire.CONTENT_TYPES["raw"],
                                              "Accept": wire.CONTENT_TYPES["json"]}, method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()
        assert srv.wire_stats["raw"]["bytes_in"] == len(body)
        assert srv.wire_stats["json"]["bytes_in"] == 0
        assert srv.wire_stats["json"]["requests"] == 1 and srv.wire_stats["json"]["bytes_out"] > 0
