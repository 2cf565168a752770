"""The tensor-parallel train step across the families, on the CPU.

Two steps of ``make_sharded_train_step`` over a gloo mesh equal two
one-process ``make_train_step`` steps on the whole batch, in
``test_torch_tp_train.hold``'s band, for:

* (1, 2) and (2, 2): gemma2-2b (the tied vocab-parallel head, softcaps,
  windows), olmoe-1b-7b (expert-parallel, qk norms; (2, 2) is in
  ``test_torch_tp_train``), hymba-1.5b (split attention beside Mamba's
  gathered ``w_in``/``w_out``), xlstm-1.3b (every recurrence's weights
  gathered, the recurrences replicated) and seamless-m4t-large-v2 (the
  encoder and the cross-attention split);
* (1, 4): gemma2-2b, whose reduced 2 KV heads the axis does not divide,
  so its attention weights are gathered and attention runs replicated.

The cases of each world size run in one spawn of gloo ranks
(``test_torch_tp_train.spawn``): the (1, 2) cases in two, the (2, 2) and
(1, 4) cases in four.
"""
import pytest

from test_torch_tp_train import hold, one_process, spawn

CASES = {(1, 2): ("gemma2-2b", "olmoe-1b-7b", "hymba-1.5b", "xlstm-1.3b",
                  "seamless-m4t-large-v2"),
         (2, 2): ("hymba-1.5b", "xlstm-1.3b", "seamless-m4t-large-v2"),
         (1, 4): ("gemma2-2b",)}
_RUNS = {}


def _run(shape, arch):
    world = shape[0] * shape[1]
    if world not in _RUNS:
        _RUNS[world] = spawn(world, {(s, a): {"arch": a, "mesh": s}
                                     for s, archs in CASES.items() if s[0] * s[1] == world
                                     for a in archs})
    return _RUNS[world][0][(shape, arch)]["run"]


@pytest.mark.parametrize("shape,arch", [(s, a) for s, archs in CASES.items() for a in archs],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_tp_step_equals_one_process_step(shape, arch):
    hold(_run(shape, arch), one_process(arch))
