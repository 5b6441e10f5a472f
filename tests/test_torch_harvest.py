"""The port's activation harvest (`data/activations.py`) against the JAX
package's, on the CPU, with a tiny subject (JAX params carried across by
`interop.lm_params_from_jax`) on numpy-seeded tokens.

Tolerances:
  - fp16 chunks: within one fp16 ulp of JAX's (the f32 forwards sum in
    another order, which may move a value across an fp16 rounding edge);
    centered chunks within one ulp each of the uncentered value, the mean
    and the result (both sides subtract in numpy fp16); int8/int4 codes within one
    code, scales within one fp16 ulp (relative 2⁻¹⁰) of the absmax;
  - `harvest_to_device` against `make_activation_dataset`: bit for bit (the
    same capture forward);
  - bf16 compute against f32: max |Δ| / max |x| < 0.05 (JAX's bound);
  - cursors, fingerprints, manifests' provenance, probe widths: exactly;
  - kill/resume and `only_chunks` repair: the chunk files' bytes exactly.
A store harvested partly by one package is resumed by the other, and every
chunk verifies in both packages' `verify_chunk` at the digest tier.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_harvest_worker as hw
from sparse_coding__tpu.data import activations as jact
from sparse_coding__tpu.data import integrity as jintegrity
from sparse_coding__tpu.lm import model as jm
from sparse_coding__tpu_torch.data import activations as tact
from sparse_coding__tpu_torch.data import integrity as tintegrity
from sparse_coding__tpu_torch.data.chunks import ChunkStore, chunk_path, save_chunk
from sparse_coding__tpu_torch.interop import lm_params_from_jax
from sparse_coding__tpu_torch.lm import model as tm
from sparse_coding__tpu_torch.telemetry.events import RunTelemetry
from sparse_coding__tpu_torch.utils import faults

REPO = Path(__file__).resolve().parents[1]
KW = dict(arch="neox", n_layers=3, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32, rotary_pct=0.25)
ROWS_A_BATCH = 8 * 16


@pytest.fixture(scope="module")
def subject():
    jc, tc = jm.LMConfig(**KW), tm.LMConfig(**KW)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tokens = np.random.default_rng(1).integers(0, 64, (64, 16)).astype(np.int32)
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), tokens


def _gb(rows, d=16):
    return rows * d * 2 / 1024**3


def _ulps(a, b):
    """fp16 bit distance, element by element."""
    ia, ib = a.view(np.int16).astype(np.int32), b.view(np.int16).astype(np.int32)
    ia, ib = np.where(ia < 0, -0x8000 - ia, ia), np.where(ib < 0, -0x8000 - ib, ib)
    return np.abs(ia - ib)


def _fp16_ulp(x):
    return np.spacing(np.abs(x.astype(np.float16))).astype(np.float32)


TIERS = ["float16", "center", "int8", "int4"]


@pytest.mark.parametrize("tier", TIERS)
def test_harvest_chunks_match_jax(tier, subject, tmp_path):
    """Two layers × (residual, mlp) in one pass, 3 chunks of two batches."""
    jc, tc, jp, tp, tokens = subject
    store = {"int8": np.int8, "int4": "int4"}.get(tier, np.float16)
    kw = dict(layers=[1, 2], layer_locs=["residual", "mlp"], batch_size=8, chunk_size_gb=_gb(2 * ROWS_A_BATCH, 32),
              n_chunks=3, center_dataset=tier == "center", store_dtype=store)
    jf = jact.make_activation_dataset(jp, jc, tokens, tmp_path / "j", **kw)
    tf = tact.make_activation_dataset(tp, tc, tokens, tmp_path / "t", device="cpu", **kw)
    assert tf == {k: jact.harvest_folder_name(tmp_path / "t", *k) for k in jf}
    for key in jf:
        if tier == "center":
            jm_, tm_ = np.load(jf[key] / "mean.npy"), np.load(tf[key] / "mean.npy")
            assert _ulps(jm_, tm_).max() <= 1
        for i in range(3):
            a, b = np.load(jf[key] / f"{i}.npy"), np.load(tf[key] / f"{i}.npy")
            assert a.dtype == b.dtype and a.shape == b.shape == (2 * ROWS_A_BATCH, a.shape[1])
            if tier == "float16":
                assert _ulps(a, b).max() <= 1, (key, i)
            elif tier == "center":
                raw = a.astype(np.float32) + jm_.astype(np.float32)
                tol = _fp16_ulp(raw) + _fp16_ulp(np.broadcast_to(jm_, raw.shape)) + _fp16_ulp(a)
                assert (np.abs(a.astype(np.float32) - b.astype(np.float32)) <= tol).all(), (key, i)
            else:
                ja, ta = np.load(jf[key] / f"{i}.scale.npy"), np.load(tf[key] / f"{i}.scale.npy")
                np.testing.assert_allclose(ta, ja, rtol=2.0 ** -10)
                if tier == "int8":
                    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
                else:
                    for shift in (4, 0):
                        na, nb = (a >> shift) & 0xF, (b >> shift) & 0xF
                        assert np.abs(na.astype(np.int32) - nb.astype(np.int32)).max() <= 1
            ok, why = jintegrity.verify_chunk(tf[key], i, depth="digest")
            assert ok, why


def test_cursor_fingerprint_and_provenance_are_the_jax_packages(subject, tmp_path):
    """The same config_sha for the same arguments (``np.float16`` and
    ``np.dtype("float16")`` hash apart, in both packages), and the same
    manifest provenance and cursor."""
    for dt in (np.float16, np.dtype("float16"), np.int8, "int4"):
        args = ([2], ["residual"], 64, 0.0625, dt, False, (768, 256))
        assert tact._harvest_config_sha(*args) == jact._harvest_config_sha(*args)
    assert tact._harvest_config_sha([2], ["residual"], 64, 0.0625, np.float16, False, (768, 256)) != \
        tact._harvest_config_sha([2], ["residual"], 64, 0.0625, np.dtype("float16"), False, (768, 256))
    jc, tc, jp, tp, tokens = subject
    kw = dict(layers=[1], layer_locs=["residual"], batch_size=8, chunk_size_gb=_gb(ROWS_A_BATCH), n_chunks=2,
              single_folder=True)
    jact.make_activation_dataset(jp, jc, tokens, tmp_path / "j", **kw)
    tact.make_activation_dataset(tp, tc, tokens, tmp_path / "t", device="cpu", **kw)
    jcur, tcur = (json.loads((tmp_path / s / tact.HARVEST_CURSOR).read_text()) for s in ("j", "t"))
    assert {k: v for k, v in tcur.items() if k != "updated_at"} == {k: v for k, v in jcur.items() if k != "updated_at"}
    for i in range(2):
        jmf, tmf = (tintegrity.read_chunk_manifest(tmp_path / s, i) for s in ("j", "t"))
        assert tmf["provenance"] == jmf["provenance"]
        assert {k: tmf[k] for k in ("rows", "shape", "store_dtype")} == {k: jmf[k] for k in ("rows", "shape", "store_dtype")}


def test_harvest_to_device_is_the_disk_store_bit_for_bit(subject, tmp_path):
    _, tc, _, tp, tokens = subject
    kw = dict(layers=[1, 2], layer_locs=["residual", "mlp"], batch_size=8, chunk_size_gb=_gb(2 * ROWS_A_BATCH, 32),
              n_chunks=2)
    folders = tact.make_activation_dataset(tp, tc, tokens, tmp_path / "disk", device="cpu", **kw)
    chunks = list(tact.harvest_to_device(tp, tc, tokens, save_folder=tmp_path / "dev", device="cpu", **kw))
    assert len(chunks) == 2
    for key, folder in folders.items():
        for i, chunk in enumerate(chunks):
            arr = chunk[key].numpy()
            assert chunk[key].dtype == torch.float16
            assert np.array_equal(arr.view(np.int16), np.load(folder / f"{i}.npy").view(np.int16))
            saved = np.load(tact.harvest_folder_name(tmp_path / "dev", *key) / f"{i}.npy")
            assert np.array_equal(arr.view(np.int16), saved.view(np.int16))
    (q,) = tact.harvest_to_device(tp, tc, tokens, layers=[1], layer_locs=["residual"], batch_size=8,
                                  chunk_size_gb=_gb(ROWS_A_BATCH), n_chunks=1, save_folder=tmp_path / "q8",
                                  store_dtype=np.int8, device="cpu")
    loaded = ChunkStore(tact.harvest_folder_name(tmp_path / "q8", 1, "residual")).load(0, device="cpu")
    assert q[(1, "residual")].dtype == torch.float16 and loaded.shape == q[(1, "residual")].shape


def test_bf16_compute_is_within_jaxs_bound_of_f32(subject):
    _, tc, _, tp, tokens = subject
    kw = dict(layers=[2], layer_locs=["residual"], batch_size=8, chunk_size_gb=_gb(ROWS_A_BATCH), n_chunks=1,
              device="cpu")
    (ref,) = tact.harvest_to_device(tp, tc, tokens, **kw)
    (bf,) = tact.harvest_to_device(tp, tc, tokens, compute_dtype="bfloat16", **kw)
    a, b = ref[(2, "residual")].float(), bf[(2, "residual")].float()
    assert not torch.equal(a, b)
    assert float((a - b).abs().max() / a.abs().max()) < 0.05


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_store_half_harvested_by_one_package_resumes_in_the_other(first, subject, tmp_path):
    jc, tc, jp, tp, tokens = subject
    kw = dict(layers=[1], layer_locs=["residual"], batch_size=8, chunk_size_gb=_gb(ROWS_A_BATCH), single_folder=True)
    folder = tmp_path / "store"
    jrun = lambda n, **k: jact.make_activation_dataset(jp, jc, tokens, folder, n_chunks=n, **kw, **k)  # noqa: E731
    trun = lambda n, **k: tact.make_activation_dataset(tp, tc, tokens, folder, n_chunks=n, device="cpu",  # noqa: E731
                                                       **kw, **k)
    (jrun if first == "jax" else trun)(2)
    written = {i: chunk_path(folder, i).read_bytes() for i in range(2)}
    (trun if first == "jax" else jrun)(4, resume=True)
    assert {i: chunk_path(folder, i).read_bytes() for i in range(2)} == written  # skipped, not rewritten
    assert json.loads((folder / tact.HARVEST_CURSOR).read_text())["chunk"] == 4
    jact.make_activation_dataset(jp, jc, tokens, tmp_path / "ref", n_chunks=4, **kw)
    for i in range(4):
        for verify in (tintegrity.verify_chunk, jintegrity.verify_chunk):
            ok, why = verify(folder, i, depth="digest")
            assert ok, (verify.__module__, i, why)
        assert _ulps(np.load(chunk_path(folder, i)), np.load(chunk_path(tmp_path / "ref", i))).max() <= 1


def _worker(folder, *args, fault=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    if fault:
        env["SC_FAULT"] = fault
    return subprocess.run([sys.executable, str(REPO / "tests" / "_torch_harvest_worker.py"), str(folder), *args],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=180)


def test_a_harvest_killed_in_the_chunk_pair_resumes_bit_exact(tmp_path):
    """SIGKILL after chunk 2's bytes landed, before its manifest: chunk 2 is
    uncommitted; the resumed harvest re-harvests it, and every chunk's bytes
    and manifest digests equal an uninterrupted harvest's."""
    ctl, vic = tmp_path / "ctl", tmp_path / "vic"
    hw.harvest(ctl)
    res = _worker(vic, fault="kill:chunk_pair:chunk=2")
    assert res.returncode == -9, (res.returncode, res.stderr[-2000:])
    assert tintegrity.read_chunk_manifest(vic, 2) is None and tintegrity.read_chunk_manifest(vic, 1) is not None
    assert json.loads((vic / tact.HARVEST_CURSOR).read_text())["chunk"] == 2
    res = _worker(vic, "--resume")
    assert res.returncode == 0, res.stderr[-2000:]
    for i in range(hw.N_CHUNKS):
        assert chunk_path(vic, i).read_bytes() == chunk_path(ctl, i).read_bytes(), i
        assert tintegrity.read_chunk_manifest(vic, i)["files"] == tintegrity.read_chunk_manifest(ctl, i)["files"]


def test_only_chunks_refills_a_hole_bit_exact(tmp_path):
    hw.harvest(tmp_path / "ctl")
    vic = tmp_path / "vic"
    hw.harvest(vic)
    cursor = (vic / tact.HARVEST_CURSOR).read_text()
    chunk_path(vic, 1).unlink()
    tintegrity.chunk_manifest_path(vic, 1).unlink()
    hw.harvest(vic, only_chunks=[1])
    assert (vic / tact.HARVEST_CURSOR).read_text() == cursor  # a repair leaves the cursor alone
    for i in range(hw.N_CHUNKS):
        assert chunk_path(vic, i).read_bytes() == chunk_path(tmp_path / "ctl", i).read_bytes(), i


def test_resume_reharvests_what_does_not_verify_and_refuses_another_config(tmp_path):
    folder = tmp_path / "s"
    hw.harvest(folder)
    good = chunk_path(folder, 1).read_bytes()
    with open(chunk_path(folder, 1), "ab") as f:
        f.write(b"\0")  # a size the manifest does not record
    with pytest.warns(RuntimeWarning, match="re-harvesting from chunk 1"):
        hw.harvest(folder, resume=True)
    assert chunk_path(folder, 1).read_bytes() == good
    cfg, params, tokens = hw.build_subject()
    with pytest.raises(ValueError, match="harvest resume refused"):
        tact.make_activation_dataset(params, cfg, tokens, folder, layers=[1], layer_locs=["residual"], batch_size=4,
                                     chunk_size_gb=_gb(64), single_folder=True, resume=True, device="cpu")


def test_spans_and_provenance_reach_a_live_run(subject, tmp_path):
    """The harvest holds no telemetry handle: its spans broadcast (`ACTIVE`)
    to whatever run is live, with one provenance event a chunk and folder."""
    _, tc, _, tp, tokens = subject
    tel = RunTelemetry(out_dir=tmp_path / "run")
    try:
        tact.make_activation_dataset(tp, tc, tokens, tmp_path / "s", layers=[1], layer_locs=["residual", "mlp"],
                                     batch_size=8, chunk_size_gb=_gb(ROWS_A_BATCH, 32), n_chunks=2, device="cpu")
    finally:
        tel.close()
    events = [json.loads(line) for line in (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
    spans = [(e["category"], e["name"], e["chunk"]) for e in events if e["event"] == "span"]
    assert spans == [("step", "harvest_forward", 0), ("checkpoint", "chunk_commit", 0),
                     ("step", "harvest_forward", 1), ("checkpoint", "chunk_commit", 1)]
    assert len([e for e in events if e["event"] == "provenance" and e["artifact"] == "chunk"]) == 4
    assert tel.counters["span.step.count"] == 2


@pytest.mark.parametrize("action,site", [("torn_chunk_pair", "chunk_pair"), ("exc", "chunk_write"),
                                         ("corrupt_chunk", "chunk_committed")])
def test_save_chunk_plants_the_jax_fault_sites(action, site, tmp_path, monkeypatch):
    data = np.random.default_rng(0).standard_normal((32, 16)).astype(np.float32)
    monkeypatch.setenv(faults.FAULT_ENV, f"{action}:{site}" if action == "exc" else action)
    faults.reset()
    try:
        if action == "corrupt_chunk":
            save_chunk(tmp_path, 0, data, dtype=np.int8)
        else:
            with pytest.raises(faults.InjectedFault):
                save_chunk(tmp_path, 0, data, dtype=np.int8)
    finally:
        faults.reset()
    if action == "exc":  # nothing landed
        assert not chunk_path(tmp_path, 0).exists()
    elif action == "torn_chunk_pair":  # the bytes landed, not the scale file nor the manifest
        assert chunk_path(tmp_path, 0).exists() and tintegrity.read_chunk_manifest(tmp_path, 0) is None
        assert not tintegrity.verify_chunk(tmp_path, 0)[0]
    else:  # committed, then bit rot that only the digest tier sees
        assert tintegrity.verify_chunk(tmp_path, 0, depth="size")[0]
        assert not tintegrity.verify_chunk(tmp_path, 0, depth="digest")[0]
        assert not jintegrity.verify_chunk(tmp_path, 0, depth="digest")[0]


def test_what_the_harvest_does_not_port_raises_naming_its_item(subject, tmp_path):
    _, tc, _, tp, tokens = subject
    kw = dict(layers=[1], layer_locs=["residual"], device="cpu")
    # the sequence-parallel harvest is ported (tests/test_torch_seqpar.py);
    # JAX's two single-device options raise its ValueError with a mesh
    with pytest.raises(ValueError, match="compute_dtype is a single-device capture option"):
        tact.make_activation_dataset(tp, tc, tokens, tmp_path, mesh=object(), compute_dtype="bfloat16", **kw)
    with pytest.raises(ValueError, match="attn is a single-device capture option"):
        next(tact.harvest_to_device(tp, tc, tokens, mesh=object(), attn="blockwise", **kw))
    # the blockwise attention is ported (tests/test_torch_blockwise.py); an
    # unknown single-card impl and the pattern under blockwise raise as in JAX
    with pytest.raises(ValueError, match="unknown single-device attn impl"):
        tact.capture_fn(tc, ["blocks.0.hook_resid_post"], 1, attn="ring")
    with pytest.raises(ValueError, match="hook_pattern needs dense attention"):
        tact.capture_fn(tc, ["blocks.0.attn.hook_pattern"], 1, attn="blockwise")(tp, torch.from_numpy(tokens[:2]))


def test_tokenization_matches_jax():
    texts = ["a b c", "", "d e f g h i j"]
    encode = lambda t: [len(w) + 3 * i for i, w in enumerate(t.split())]  # noqa: E731
    for n in (2, 3, 5):
        got = tact.chunk_and_tokenize_texts(texts, encode, eos_id=0, max_length=n)
        want = jact.chunk_and_tokenize_texts(texts, encode, eos_id=0, max_length=n)
        assert got.dtype == np.int32 and np.array_equal(got, want)


class _Tokenizer:
    eos_token_id = 0

    def __call__(self, text):
        return {"input_ids": [1 + (ord(c) % 60) for c in text]}


def test_init_model_dataset_harvests_an_empty_folder_through_setup_data(tmp_path, monkeypatch):
    """Local stand-ins for the model load, the tokenizer and the dataset
    (no network): the empty folder is harvested with the config's layer,
    location, chunk size, chunk count and harvest dtypes, then loaded."""
    from sparse_coding__tpu_torch.train import sweep as tsweep
    from sparse_coding__tpu_torch.utils.config import EnsembleArgs

    cfg_lm, params, _ = hw.build_subject()
    seen = {}

    def load_model(name, dtype=torch.float32, device=None):
        seen["model"], seen["device"] = name, device
        return cfg_lm, params

    texts = [" ".join(f"doc{i} word{j}" for j in range(40)) for i in range(120)]
    monkeypatch.setattr(tact, "load_model", load_model)
    monkeypatch.setattr(tact, "load_tokenizer", lambda name: _Tokenizer())
    monkeypatch.setattr(tact, "make_sentence_dataset", lambda name, max_lines=0: {"text": texts})
    cfg = EnsembleArgs(model_name="local-subject", dataset_name="local-text", dataset_folder=str(tmp_path / "acts"),
                       output_folder=str(tmp_path / "o"), layer=1, layer_loc="residual", n_chunks=2,
                       chunk_size_gb=_gb(64 * 256), harvest_store_dtype="int8")
    store = tsweep.init_model_dataset(cfg, device="cpu")
    assert seen == {"model": "local-subject", "device": torch.device("cpu")}
    assert len(store) == 2 and store.n_datapoints() == 2 * 64 * 256
    assert tintegrity.read_chunk_manifest(tmp_path / "acts", 0)["store_dtype"] == "int8"
    cursor = json.loads((tmp_path / "acts" / tact.HARVEST_CURSOR).read_text())
    tokens = tact.setup_token_data("local-text", _Tokenizer(), max_length=256)
    assert cursor["config_sha"] == jact._harvest_config_sha([1], ["residual"], 64, _gb(64 * 256), np.dtype("int8"),
                                                            False, tokens.shape)
    assert tsweep.init_model_dataset(cfg, device="cpu").folder == store.folder  # a second call loads


def test_run_single_layer_sizes_its_dictionaries_from_the_subject_model(tmp_path):
    """No ``activation_width``: the width is `get_activation_size` of the
    model name at the location (Pythia-14M's residual: 128), here over a
    store harvested from a 128-wide subject, with the default builder
    (`dense_l1_range_experiment`: 16 members) at ratio 1."""
    from sparse_coding__tpu_torch.train import experiments as texp

    cfg = tm.LMConfig(arch="neox", n_layers=1, d_model=128, n_heads=4, d_mlp=256, vocab_size=64, n_ctx=32)
    tokens = np.random.default_rng(2).integers(0, 64, (16, 16)).astype(np.int32)
    tact.make_activation_dataset(tm.init_params(3, cfg, device="cpu"), cfg, tokens, tmp_path / "acts", layers=[0],
                                 layer_locs=["residual"], batch_size=8, chunk_size_gb=_gb(128, 128), n_chunks=2,
                                 single_folder=True, device="cpu")
    lds = texp.run_single_layer(layer=0, ratio=1, device="cpu", model_name="EleutherAI/pythia-14m",
                                dataset_folder=str(tmp_path / "acts"), output_folder=str(tmp_path / "out"),
                                batch_size=64, n_epochs=1)
    assert len(lds) == 16 and {hp["dict_size"] for _, hp in lds} == {128}
    assert all(ld.get_learned_dict().shape == (128, 128) for ld, _ in lds)
