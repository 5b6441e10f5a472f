"""FastICA baseline (host-side sklearn, tensors at the boundary).

Counterpart of `sparse_coding__tpu/models/ica.py`. ICA is an offline
baseline fit once per layer; it runs in sklearn on the host (imported when
an encoder is made: the card's machine has no sklearn). Codes come back on
the input's device; the dictionary on the encoder's ``device`` (None =
cuda).
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict
from sparse_coding__tpu_torch.models.topk import TopKLearnedDict
from sparse_coding__tpu_torch.utils.device import resolve_device


def _host_f64(x) -> np.ndarray:
    """Rows as a float64 host array (a tensor's device copy comes back)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


class ICAEncoder(LearnedDict):
    """StandardScaler + FastICA."""

    def __init__(self, activation_size: int, n_components: int = 0, device=None, **ica_kwargs):
        from sklearn.decomposition import FastICA
        from sklearn.preprocessing import StandardScaler

        self.activation_size = activation_size
        self.n_feats = n_components if n_components else activation_size
        if n_components:
            ica_kwargs.setdefault("n_components", n_components)
        self.ica = FastICA(**ica_kwargs)
        self.scaler = StandardScaler()
        self.device = resolve_device(device)

    def train(self, dataset) -> np.ndarray:
        assert dataset.shape[1] == self.activation_size
        rescaled = self.scaler.fit_transform(_host_f64(dataset))
        return self.ica.fit_transform(rescaled)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        assert x.shape[1] == self.activation_size
        x_std = self.scaler.transform(_host_f64(x))
        return torch.as_tensor(self.ica.transform(x_std), dtype=torch.float32).to(x.device)

    def get_learned_dict(self) -> torch.Tensor:
        components = torch.as_tensor(self.ica.components_, dtype=torch.float32).to(self.device)
        return components / torch.linalg.vector_norm(components, dim=-1, keepdim=True)

    def to_topk_dict(self, sparsity: int) -> TopKLearnedDict:
        """± components → top-k dict."""
        pos = np.asarray(self.ica.components_)
        comps = torch.as_tensor(np.concatenate([pos, -pos], axis=0), dtype=torch.float32).to(self.device)
        return TopKLearnedDict(comps, sparsity)
