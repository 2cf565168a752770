"""Elastic mesh replanning: recompute the mesh after losing hosts.

Port of ``repro/dist/elastic.py`` (host logic, copied).

When the heartbeat monitor declares a host dead, the surviving job
restarts on fewer chips.  Model parallelism is pinned by the checkpoint's
weight shards (``model_parallel`` must divide every sharded dim the same
way), so only the data dimension absorbs the loss: ``replan_mesh`` keeps
the model axis and gives the remaining chips to data — 512 chips at
TP=16 is a (32, 16) mesh; lose a 32-chip host and it replans to
(30, 16).  In sharded serving the data axis is the shard count
(``ShardedANNEngine.reshard``).

``multi_pod`` preserves the physical pod axis (256 chips per pod) so ICI
vs DCI collectives keep their cost structure after the replan.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["replan_mesh", "POD_CHIPS"]

POD_CHIPS = 256          # one 16x16 pod


def replan_mesh(
    n_devices: int, model_parallel: int, multi_pod: bool = False
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Mesh (shape, axis_names) for ``n_devices`` at fixed model parallelism.

    Raises ``ValueError`` when the device count cannot host the pinned
    model axis (fewer chips than ``model_parallel``, or not divisible).
    """
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot host model_parallel={model_parallel}"
        )
    if n_devices % model_parallel:
        raise ValueError(
            f"{n_devices} devices not divisible by model_parallel={model_parallel}"
        )
    if multi_pod:
        if n_devices % POD_CHIPS or POD_CHIPS % model_parallel:
            raise ValueError(
                f"multi_pod replan needs whole {POD_CHIPS}-chip pods that "
                f"fit model_parallel={model_parallel}; got {n_devices} devices"
            )
        pods = n_devices // POD_CHIPS
        return (pods, POD_CHIPS // model_parallel, model_parallel), (
            "pod", "data", "model",
        )
    return (n_devices // model_parallel, model_parallel), ("data", "model")
