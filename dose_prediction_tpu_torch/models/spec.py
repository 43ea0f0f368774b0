"""Each model's constructor arguments, recorded so that a checkpoint can say
which graph it was trained with (counterpart of
dose_prediction_tpu/infer/aot.py::model_spec, :329-341: a flax module's
dataclass fields). The train resume guard and the CLI's eval/serve check
compare ``model_spec(model)`` with the ``run_config.json`` that training
wrote."""

from __future__ import annotations

import functools
import inspect

# where the model's parameters live is not part of its graph
_NOT_RECORDED = ("self", "device")


def records_config(init):
    """Decorate a model's ``__init__``: its bound arguments, defaults
    included, are kept as ``model.config``."""
    signature = inspect.signature(init)

    @functools.wraps(init)
    def wrapper(self, *args, **kwargs):
        bound = signature.bind(self, *args, **kwargs)
        bound.apply_defaults()
        init(self, *args, **kwargs)
        self.config = {k: v for k, v in bound.arguments.items() if k not in _NOT_RECORDED}

    return wrapper


def model_spec(model) -> dict:
    """JSON-able dict of ``model``'s constructor arguments: numbers,
    strings, booleans and None as they are, sequences as lists, anything
    else as its ``str``."""
    out = {}
    for k, v in model.config.items():
        if isinstance(v, (int, float, bool, str, type(None))):
            out[k] = v
        elif isinstance(v, (tuple, list)):
            out[k] = list(v)
        else:
            out[k] = str(v)
    return out
