"""``compile_train_step``: the counterpart of
``paddle_tpu/jit/__init__.py:513``.

The JAX package traces forward, backward, clipping and the optimizer
update into one jitted program with donated state. PyTorch runs eagerly,
so here nothing is compiled: the returned step runs the same four phases
eagerly, on the optimizer's own state, and is exactly the eager loop
``loss = loss_fn(model, *batch); loss.backward(); optimizer.step();
optimizer.clear_grad()``. The name stays so that a reader finds the
counterpart. (Unlike the JAX program, the eager step honours AdamW's
``lr_ratio`` and ``apply_decay_param_fun``, and the optimizer's
``state_dict`` stays live across steps.)
"""

from __future__ import annotations


def compile_train_step(model, loss_fn, optimizer, donate=True,
                       extra_rng=True, fuse=None, remat_policy=None):
    """Returns step(*batch) -> 0-dim loss tensor (detached), which runs
    forward (``loss_fn(model, *batch)``), backward, the optimizer's
    gradient clip and update, and clears the gradients. donate and
    extra_rng have no counterpart in eager PyTorch and are ignored;
    fuse=True and remat_policy raise: remat a model's layers with
    ``models.apply_llama_remat`` or ``distributed.fleet.utils.recompute``
    instead."""
    if fuse:
        raise NotImplementedError(
            "fuse=True (the graph-compiler pass pipeline) comes with the "
            "compiler slice of the port")
    if remat_policy == "fused":
        raise NotImplementedError(
            "remat_policy='fused' (save only the fused ops' outputs) needs "
            "the compiler's remat tags and comes with the compiler slice "
            "of the port")
    if remat_policy is not None:
        raise NotImplementedError(
            f"remat_policy={remat_policy!r}: a JAX checkpoint policy over "
            "the whole traced loss program needs a traced program, which "
            "the eager step has not; remat the layers with "
            "models.apply_llama_remat or distributed.fleet.utils.recompute")

    def step(*batch):
        loss = loss_fn(model, *batch)
        loss.backward()
        optimizer.step()
        optimizer.clear_grad()
        return loss.detach()

    return step


__all__ = ["compile_train_step"]
