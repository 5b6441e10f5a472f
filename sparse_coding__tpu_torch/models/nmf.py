"""NMF baseline (host-side sklearn, tensors at the boundary).

Counterpart of `sparse_coding__tpu/models/nmf.py`: non-negative matrix
factorization with a shift-to-positive preprocessing step. Offline
baseline, sklearn on the host, like ICA (`models/ica.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_coding__tpu_torch.models.ica import _host_f64
from sparse_coding__tpu_torch.models.learned_dict import LearnedDict
from sparse_coding__tpu_torch.models.topk import TopKLearnedDict
from sparse_coding__tpu_torch.utils.device import resolve_device


class NMFEncoder(LearnedDict):
    """Shift-to-positive + sklearn NMF."""

    def __init__(self, activation_size: int, n_components: int = 0, shift: float = 0.0, device=None, **nmf_kwargs):
        from sklearn.decomposition import NMF

        self.activation_size = activation_size
        self.n_feats = n_components if n_components else activation_size
        if n_components:
            nmf_kwargs.setdefault("n_components", n_components)
        self.nmf = NMF(**nmf_kwargs)
        self.shift = shift
        self.device = resolve_device(device)

    def train(self, dataset):
        data = _host_f64(dataset)
        data_min = float(data.min())
        if data_min < self.shift:
            self.shift = data_min
        self.nmf.fit(data - self.shift)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        x_np = _host_f64(x)
        if x_np.min() < self.shift:
            print("Warning: data has values below expected minimum for NMF.")
        x_np = np.clip(x_np - self.shift, 0.0, None)
        return torch.as_tensor(self.nmf.transform(x_np), dtype=torch.float32).to(x.device)

    def get_learned_dict(self) -> torch.Tensor:
        """Row-normalized components (the unit-norm rows the cosine metrics
        rely on). The coefficient matrix H is not recovered by multiplying
        with this."""
        components = torch.as_tensor(self.nmf.components_, dtype=torch.float32).to(self.device)
        return components / torch.clamp(torch.linalg.vector_norm(components, dim=-1, keepdim=True), min=1e-8)

    def to_topk_dict(self, sparsity: int) -> TopKLearnedDict:
        return TopKLearnedDict(self.get_learned_dict(), sparsity)
