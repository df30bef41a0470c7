"""Shared hybrid-parallel state: the counterpart of
``paddle_tpu/distributed/_state.py``. The port's hybrid mesh is the
topology's ``HybridCommunicateGroup.mesh`` (one ``DeviceMesh`` over the
axes dp, pp, sharding, mp, sep), which exists whenever a topology does,
since devices may repeat; these are accessors over it."""

from __future__ import annotations

from .fleet.base.topology import get_hcg  # noqa: F401

hcg_state = {"mesh": None}       # a mesh set without a topology


def set_hybrid_mesh(mesh):
    hcg = get_hcg()
    if hcg is not None:
        hcg.mesh = mesh
    hcg_state["mesh"] = mesh


def get_hybrid_mesh():
    hcg = get_hcg()
    return hcg.mesh if hcg is not None else hcg_state["mesh"]
