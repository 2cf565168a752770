"""The port's public surface for the runtime, fleet, obs and checkpoint
layers matches the JAX package's: the same exported names in each layer,
and the engines' observability and planning hooks with the same
parameters (the port's ``Checkpointer.restore`` takes ``device`` where the
reference takes ``shardings``)."""
import importlib
import inspect

import pytest

import repro.core.engine as ref_engine
import repro.serve.engine as ref_serve
import repro_torch.core.engine as port_engine
import repro_torch.serve.engine as port_serve

HOOKS = {
    "FilteredANNEngine": ("stats", "set_tracer", "swap_planner", "plan", "plan_ex",
                          "plan_batch", "plan_batch_ex", "make_plan", "make_plan_batch"),
    "ShardedANNEngine": ("stats", "set_tracer", "runtime"),
}


@pytest.mark.parametrize("cls,method", [(c, m) for c, ms in HOOKS.items() for m in ms])
def test_engine_hooks_have_the_reference_parameters(cls, method):
    mod, rmod = ((port_engine, ref_engine) if cls == "FilteredANNEngine"
                 else (port_serve, ref_serve))
    sig = inspect.signature(getattr(getattr(mod, cls), method))
    rsig = inspect.signature(getattr(getattr(rmod, cls), method))
    assert list(sig.parameters) == list(rsig.parameters)
    assert [p.default for p in sig.parameters.values()] == \
        [p.default for p in rsig.parameters.values()]


@pytest.mark.parametrize("layer", ["obs", "runtime", "fleet", "ckpt"])
def test_layers_export_the_reference_names(layer):
    port = importlib.import_module(f"repro_torch.{layer}")
    ref = importlib.import_module(f"repro.{layer}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


def test_checkpointer_restore_takes_device():
    from repro.ckpt import Checkpointer as Ref
    from repro_torch.ckpt import Checkpointer

    params = list(inspect.signature(Checkpointer.restore).parameters)
    rparams = list(inspect.signature(Ref.restore).parameters)
    assert params[:-1] == rparams[:-1] and (params[-1], rparams[-1]) == ("device", "shardings")
