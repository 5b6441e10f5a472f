"""Pickles that cross the two packages.

Some files are plain pickles of objects rather than export records: the
baselines' dictionaries (`train/baselines.py`), the autointerp results
(``scored_simulation.pkl``, ``neuron_record.pkl``) and the interp CLI's
``lm_params`` (a pickle of ``(params, LMConfig)``). The JAX package writes
them with its own class paths and JAX array leaves; unpickled as they are,
they would import JAX. So both directions rename, as the export records do
(`train.checkpoint.export_class_path`):

  - `dump` writes a port object under the JAX package's path of the same
    class (the two packages lay their modules out alike), tensors as numpy
    arrays, so the JAX package's `pickle.load` rebuilds its own objects;
  - `load` maps the JAX package's class paths onto the port's classes, a
    JAX array onto its numpy value, and turns the numpy leaves of the
    registered learned dicts and of plain dicts/lists/tuples into tensors
    on ``device``.

Only files this program or the JAX package wrote should be loaded:
unpickling runs code.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import pickle
from typing import Any

import numpy as np
import torch

# the model modules register their learned-dict classes: `models` imports
# them all, so every class a pickle names is there to be found
import sparse_coding__tpu_torch.models  # noqa: F401
from sparse_coding__tpu_torch.models.learned_dict import LEARNED_DICT_REGISTRY, LearnedDict, dict_leaves, with_leaves
from sparse_coding__tpu_torch.utils.device import resolve_device

# the port's top-level package and the JAX package's name (the same without
# the suffix), spelled from the port's own name
_PORT_PACKAGE = __name__.split(".")[0]
_JAX_PACKAGE = _PORT_PACKAGE[: -len("_torch")]


def _reconstruct_array(fun, args, arr_state, aval_state):
    """A pickled JAX array (`jax._src.array._reconstruct_array`'s arguments)
    as its numpy value."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "jax._src.array" and name == "_reconstruct_array":
            return _reconstruct_array
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
        return super().find_class(module, name)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing each port class under the JAX
    package's module path."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", "") or ""
        if isinstance(obj, type) and (module == _PORT_PACKAGE or module.startswith(_PORT_PACKAGE + ".")):
            self.save(_JAX_PACKAGE + module[len(_PORT_PACKAGE):])
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _to_numpy(obj):
    """Tensors as numpy arrays: in learned dicts' array fields and in plain
    dicts, lists and tuples; a dict's ``device`` as its name."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, LearnedDict):
        if type(obj) in LEARNED_DICT_REGISTRY:
            obj = with_leaves(obj, [_to_numpy(v) for _, _, v in dict_leaves(obj)])
        else:
            obj = copy.copy(obj)
        if isinstance(getattr(obj, "device", None), torch.device):
            obj.device = str(obj.device)
        return obj
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def to_tensors(obj, device):
    """Numpy leaves as tensors on ``device``: in learned dicts' array fields
    and in plain dicts, lists and tuples (a dataclass or any other object is
    kept as it is). A learned dict without array fields, or one that keeps
    its arrays on the host (the sklearn baselines), makes its tensors on
    ``device``. A 0-d object array (how the JAX package's tree map stores an
    object that is no pytree) is unwrapped."""
    if isinstance(obj, np.ndarray):
        if obj.dtype == object and obj.ndim == 0:
            return to_tensors(obj.item(), device)
        if obj.dtype != object:
            return torch.from_numpy(np.array(obj)).to(device)
    if isinstance(obj, LearnedDict):
        leaves = dict_leaves(obj) if type(obj) in LEARNED_DICT_REGISTRY else []
        if leaves:
            return with_leaves(obj, [to_tensors(v, device) for _, _, v in leaves])
        obj.device = torch.device(device)
        return obj
    if isinstance(obj, dict):
        return {k: to_tensors(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields") and not dataclasses.is_dataclass(obj):
        return type(obj)(to_tensors(v, device) for v in obj)
    return obj


def dumps(obj) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(_to_numpy(obj))
    return buf.getvalue()


def dump(obj, f) -> None:
    """Pickle ``obj`` for either package (see the module docstring)."""
    f.write(dumps(obj))


def loads(data: bytes, device=None) -> Any:
    """Unpickle a file of either package; numpy leaves become tensors on
    ``device`` (None = cuda)."""
    device = resolve_device(device)
    return to_tensors(_Unpickler(io.BytesIO(data)).load(), device)


def load(f, device=None) -> Any:
    return loads(f.read(), device=device)


def load_raw(f) -> Any:
    """Unpickle a file of either package, leaving its leaves as numpy."""
    return _Unpickler(f).load()

