"""The port's ``repro_torch.models`` re-exports the JAX package's eleven
names of ``models/model.py``, each the port's own function, and the
exported entry points build the same trees as the reference's."""
import dataclasses

import pytest

import repro.models as RM
import repro_torch.models as TM
from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_arch as r_arch
from repro.configs import reduced as r_reduced
from repro_torch.configs import SHAPES, get_arch, reduced
from repro_torch.models import model as model_py

NAMES = ["param_specs", "init_params", "abstract_params", "forward_hidden",
         "logits_from_hidden", "loss_fn", "prefill", "decode_step", "init_cache",
         "input_specs", "abstract_cache"]


def test_models_reexports_the_reference_names():
    ref = sorted(n for n in vars(RM) if not n.startswith("_") and callable(getattr(RM, n)))
    got = sorted(n for n in vars(TM) if not n.startswith("_") and callable(getattr(TM, n)))
    assert ref == sorted(NAMES) == got
    for n in NAMES:
        assert getattr(TM, n) is getattr(model_py, n), n
    assert "Dense decoder models" not in TM.__doc__


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m", "whisper-medium"])
def test_exported_specs_equal_reference(arch):
    cfg, rcfg = reduced(get_arch(arch)), r_reduced(r_arch(arch))
    flat = lambda t: sorted((k, tuple(v.shape)) for k, v in _items(t))  # noqa: E731
    assert flat(TM.param_specs(cfg)) == flat(RM.param_specs(rcfg))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=2)
    rshape = dataclasses.replace(R_SHAPES["train_4k"], seq_len=16, global_batch=2)
    got, want = TM.input_specs(cfg, shape), RM.input_specs(rcfg, rshape)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
