"""The port's chunk-store scrub (`data/scrub.py`, the `scrub` shim) and the
exact-index regeneration it repairs with (`data.chunks.generate_synthetic_
chunks(only_chunks=)`) against the JAX package's, on the CPU.

Verification, quarantine, hole accounting and the markdown are JAX's, on
copies of the same stores (exact). A repair gives back the bits of a chunk
the port wrote, on the device type that drew it (exact). A store the JAX
package's generators wrote cannot get its bits back from the port's
`torch.Generator` streams: the repair refuses, naming the producer it found,
and writes nothing under the index.
"""

import contextlib
import importlib
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch.data import integrity
from sparse_coding__tpu_torch.data import scrub as tscrub
from sparse_coding__tpu_torch.data.chunks import chunk_path, generate_synthetic_chunks, save_chunk
from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator, SparseMixDataset

GEN = dict(activation_dim=16, n_ground_truth_components=32, batch_size=128, feature_num_nonzero=4,
           feature_prob_decay=0.99, correlated=False)
SPEC = dict(n_chunks=4, chunk_size_gb=128 * 16 * 2 / 1024**3, activation_width=16)
CONFIG = {"kind": "synthetic", "generator": {**GEN, "class": "RandomDatasetGenerator", "seed": 5}, **SPEC}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _jscrub():
    return importlib.import_module("sparse_coding__tpu.data.scrub")


def _port_store(folder):
    generate_synthetic_chunks(RandomDatasetGenerator(**GEN, key=5, device="cpu"), folder, **SPEC)
    return folder


def _damage(store):
    """A flipped byte in chunk 1, chunk 3's data gone (its manifest left), a
    stale temp of a dead writer."""
    p = chunk_path(store, 1)
    p.write_bytes(p.read_bytes()[:-1] + bytes([p.read_bytes()[-1] ^ 0x55]))
    chunk_path(store, 3).unlink()
    (store / ".2.npy.tmp999999999").write_bytes(b"torn")


def test_scrub_matches_jax_on_the_same_damage(tmp_path):
    _port_store(tmp_path / "base")
    _damage(tmp_path / "base")
    port, jx = tmp_path / "A", tmp_path / "B"
    for d in (port, jx):
        shutil.copytree(tmp_path / "base", d)
    same = lambda text, d: text.replace(str(d), "STORE")  # noqa: E731
    got = tscrub.scrub_store(port)
    want = _jscrub().scrub_store(jx)
    assert {**got, "store": None} == {**want, "store": None}
    assert got["missing"] == [1, 3] and got["swept_temps"] == [".2.npy.tmp999999999"]
    assert same(tscrub.render_scrub_markdown(got), port) == same(_jscrub().render_scrub_markdown(want), jx)
    # a second pass sees them quarantined before; store_loss mutates nothing
    assert tscrub.store_loss(port) == _jscrub().store_loss(jx)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jx))
    rc_t, out_t = _run(tscrub.main, [str(port), "--depth", "size"])
    rc_j, out_j = _run(_jscrub().main, [str(jx), "--depth", "size"])
    assert (rc_t, same(out_t, port)) == (rc_j, same(out_j, jx)) and rc_t == 1


def test_only_chunks_draws_every_chunk_and_writes_the_selected(tmp_path):
    _port_store(tmp_path / "full")
    generate_synthetic_chunks(RandomDatasetGenerator(**GEN, key=5, device="cpu"), tmp_path / "part",
                              only_chunks=[0, 2], **SPEC)
    assert sorted(p.name for p in (tmp_path / "part").glob("*.npy")) == ["0.npy", "2.npy"]
    for i in (0, 2):
        assert chunk_path(tmp_path / "part", i).read_bytes() == chunk_path(tmp_path / "full", i).read_bytes()
    stamp = integrity.read_chunk_manifest(tmp_path / "full", 1)["provenance"]
    assert stamp == {"synthetic": {"producer": "sparse_coding__tpu_torch", "generator": "RandomDatasetGenerator",
                                   "device": "cpu"}}
    # the JAX package's regeneration over its own stream keeps the same contract
    jchunks = importlib.import_module("sparse_coding__tpu.data.chunks")
    jsyn = importlib.import_module("sparse_coding__tpu.data.synthetic")
    import jax

    jchunks.generate_synthetic_chunks(jsyn.RandomDatasetGenerator(**GEN, key=jax.random.PRNGKey(5)),
                                      tmp_path / "jpart", only_chunks=[1], **SPEC)
    assert [p.name for p in (tmp_path / "jpart").glob("*.npy")] == ["1.npy"]


@pytest.mark.parametrize("cls,extra", [("RandomDatasetGenerator", {}),
                                       ("SparseMixDataset", {"noise_magnitude_scale": 0.01})])
def test_repair_gives_back_the_bits_the_port_wrote(tmp_path, cls, extra):
    gen_kw = dict(GEN)
    if cls == "SparseMixDataset":
        gen_kw = dict(activation_dim=16, n_sparse_components=32, batch_size=128, feature_num_nonzero=4,
                      feature_prob_decay=0.99, **extra)
        generate_synthetic_chunks(SparseMixDataset(**gen_kw, key=9, device="cpu"), tmp_path / "s", **SPEC)
    else:
        _port_store(tmp_path / "s")
    original = {i: chunk_path(tmp_path / "s", i).read_bytes() for i in range(SPEC["n_chunks"])}
    _damage(tmp_path / "s")
    cfg = {"kind": "synthetic", "generator": {**gen_kw, "class": cls, "seed": 9 if extra else 5}, **SPEC}
    (tmp_path / "repair.json").write_text(json.dumps(cfg))
    rc, out = _run(tscrub.main, [str(tmp_path / "s"), "--repair", str(tmp_path / "repair.json")])
    assert rc == 0 and "1 repaired" not in out and "2 repaired" in out
    for i, raw in original.items():
        assert chunk_path(tmp_path / "s", i).read_bytes() == raw, i
    assert tscrub.scrub_store(tmp_path / "s")["missing"] == []


def test_a_jax_written_store_is_refused_naming_its_producer(tmp_path):
    jchunks = importlib.import_module("sparse_coding__tpu.data.chunks")
    jsyn = importlib.import_module("sparse_coding__tpu.data.synthetic")
    import jax

    store = tmp_path / "jax_store"
    jchunks.generate_synthetic_chunks(jsyn.RandomDatasetGenerator(**GEN, key=jax.random.PRNGKey(5)), store, **SPEC)
    p = chunk_path(store, 2)
    p.write_bytes(p.read_bytes()[:-1] + b"\x00")
    (tmp_path / "repair.json").write_text(json.dumps(CONFIG))
    rc, out = _run(tscrub.main, [str(store), "--repair", str(tmp_path / "repair.json")])
    assert rc == 1 and "repair refused" in out and "unstamped producer" in out
    assert not chunk_path(store, 2).exists()  # nothing else written under the index
    with pytest.raises(tscrub.RepairRefused, match="not written by sparse_coding__tpu_torch"):
        tscrub.repair_from_config(store, [2], CONFIG)
    # the JAX package's own repair gives its bits back
    assert _run(_jscrub().main, [str(store), "--repair", str(tmp_path / "repair.json")])[0] == 0


def test_a_store_drawn_on_another_device_type_is_refused(tmp_path):
    store = _port_store(tmp_path / "s")
    for i in range(SPEC["n_chunks"]):
        mp = integrity.chunk_manifest_path(store, i)
        man = json.loads(mp.read_text())
        man["provenance"]["synthetic"]["device"] = "cuda"
        mp.write_text(json.dumps(man))
    chunk_path(store, 0).unlink()
    if not torch.cuda.is_available():
        with pytest.raises(tscrub.RepairRefused, match="CUDA"):
            tscrub.repair_from_config(store, [0], CONFIG)
    # the config may name the device: the CPU's draw is then the CPU's stream
    assert tscrub.repair_from_config(store, [0], {**CONFIG, "device": "cpu"}) == [0]


def test_repair_kinds(tmp_path, monkeypatch):
    assert tscrub.repair_from_config(tmp_path, [], CONFIG) == []
    with pytest.raises(ValueError, match="unknown repair config kind"):
        tscrub.repair_from_config(tmp_path, [0], {"kind": "magic"})
    act = importlib.import_module("sparse_coding__tpu_torch.data.activations")
    calls = []

    def fake_setup(**kw):
        calls.append(kw)
        save_chunk(tmp_path, 0, np.ones((4, 16), np.float32))

    monkeypatch.setattr(act, "setup_data", fake_setup)
    cfg = {"kind": "harvest", "setup": {"model_name": "m", "dataset_name": "d", "dataset_folder": str(tmp_path),
                                        "layer": 2}}
    assert tscrub.repair_from_config(tmp_path, [0], cfg) == [0]
    assert calls == [{**cfg["setup"], "resume": True}]
