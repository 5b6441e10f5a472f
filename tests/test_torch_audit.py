"""The port's transfer audit (`telemetry/audit.py`) on the CPU:
`tests/test_telemetry.py:261-290`'s cases against the port's train loop,
and the interposer's own contract. On the CPU only the Python interposer
acts (nothing syncs); the CUDA layer (``torch.cuda.set_sync_debug_mode``)
is held on the card by `tests/test_torch_kernels_cuda.py`'s audit test and
chip_smoke's ``profiling`` phase.
"""

import pytest
import torch

from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.telemetry import RunTelemetry, TransferViolation, allowed_transfer, read_events
from sparse_coding__tpu_torch.telemetry import audit
from sparse_coding__tpu_torch.train.loop import ensemble_train_loop
from sparse_coding__tpu_torch.utils.logging import MetricLogger
from sparse_coding__tpu_torch.utils.trace import StepTimer

D, N = 16, 32


def _build(health=True, n_models=2, seed=0):
    return build_ensemble(FunctionalTiedSAE, seed, [{"l1_alpha": 10 ** (-4 + i)} for i in range(n_models)],
                          optimizer_kwargs={"learning_rate": 1e-3}, activation_size=D, n_dict_components=N,
                          health=health, device="cpu")


def _data(rows=256, seed=1):
    return torch.randn((rows, D), generator=torch.Generator().manual_seed(seed))


def test_transfer_audit_clean_hot_loop_passes(tmp_path):
    """The loop with buffered logging makes no host pull outside the
    sanctioned flush and probe points — both loop routes."""
    ens = _build(health=True)
    logger = MetricLogger(out_dir=str(tmp_path), run_name="audit")
    with audit.transfer_audit():
        ensemble_train_loop(ens, _data(512), batch_size=64, key=5, logger=logger, log_every=4)
        ensemble_train_loop(ens, _data(512), batch_size=64, key=6, logger=logger, log_every=4,
                            bulk_shuffle_max_bytes=0)
        timer = StepTimer()
        timer.tick()
        assert timer.report(fence=ens.state.params["encoder"])["steps"] == 1
    logger.close()
    assert len((tmp_path / "audit_metrics.jsonl").read_text().splitlines()) > 0


def test_transfer_audit_catches_in_loop_item(tmp_path):
    ens = _build(health=False)
    tel = RunTelemetry(out_dir=str(tmp_path), run_name="audit_bad")
    leak = lambda i, n: ens.state.params["encoder"].sum().item()  # noqa: E731  (the .item() sin)
    with pytest.raises(TransferViolation, match="Tensor.item"):
        with audit.transfer_audit(telemetry=tel):
            ensemble_train_loop(ens, _data(256), batch_size=32, key=6, progress_callback=leak, dead_check=False)
    tel.close()
    kinds = [e for e in read_events(tmp_path / "events.jsonl") if e["event"] == "anomaly"]
    assert kinds and kinds[0]["kind"] == "transfer_guard"


@pytest.mark.parametrize("pull", ["item", "tolist", "cpu", "numpy", "__float__"])
def test_every_explicit_pull_is_interposed_and_restored(pull):
    t = torch.ones(())
    before = torch.Tensor.__dict__.get(pull)
    call = (lambda: float(t)) if pull == "__float__" else (lambda: getattr(t, pull)())
    with audit.transfer_audit():
        with pytest.raises(TransferViolation, match=pull):
            call()
        with allowed_transfer():
            call()
        with audit.transfer_audit():  # nested audits share the interposer
            with pytest.raises(TransferViolation):
                call()
        with pytest.raises(TransferViolation):
            call()
    call()
    assert torch.Tensor.__dict__.get(pull) is before


def test_other_errors_pass_untouched_and_other_threads_are_not_audited():
    import threading

    with pytest.raises(KeyError):
        with audit.transfer_audit():
            raise KeyError("not a transfer")
    seen = []
    with audit.transfer_audit():
        th = threading.Thread(target=lambda: seen.append(torch.ones(2).sum().item()))
        th.start()
        th.join()
    assert seen == [2.0]
