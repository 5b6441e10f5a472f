"""Importable `import:` payload drivers for the port's fleet tests (see
`sparse_coding__tpu_torch.fleet.worker.run_item`), the counterparts of
`tests/_fleet_drivers.py` on the port's preemption flag: a slow driver that
honors the flag at its poll boundary like a real training loop, a quick
driver that leaves a verifiable learned-dict export, and one that raises an
operator's Ctrl-C."""

import time
from pathlib import Path

from sparse_coding__tpu_torch.train import preemption


def slow_driver(output_folder, resume=None, seconds=30.0, poll=0.05):
    """Spin until `seconds` elapse, polling the preemption flag the way a
    real driver polls at chunk boundaries."""
    deadline = time.time() + seconds
    while time.time() < deadline:
        if preemption.preemption_requested():
            raise preemption.Preempted("preempted at poll boundary")
        time.sleep(poll)
    return []


def quick_driver(output_folder, resume=None):
    """Instantly 'train': write an export the manifest can verify."""
    out = Path(output_folder) / "epoch_0"
    out.mkdir(parents=True, exist_ok=True)
    (out / "learned_dicts.pkl").write_bytes(b"quick-dict-bytes")
    return []


def interrupt_driver(output_folder, resume=None):
    """Simulate an operator Ctrl-C landing inside the driver."""
    raise KeyboardInterrupt
