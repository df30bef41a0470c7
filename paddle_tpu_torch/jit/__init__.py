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

As the JAX package's fused program folds the update into its one
program, the step runs the optimizer's update without the "optimizer"
phase that an eager ``Optimizer.step`` reports to an active
``perf.StepTimer``: the whole step is the caller's (dispatch, compute).
The first step made while telemetry is enabled runs under an
``observability.xla_introspect`` counter and registers the program as
"train_step" (the first train step of the process; later ones
"train_step#<n>", the JAX labels): its flops, bytes and memory. Counting
slows that one step; a telemetry error never blocks it.
"""

from __future__ import annotations

# ordinal labels for xla_introspect registration, as in the JAX package
_TRAIN_STEP_IDS = [0]


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

    _TRAIN_STEP_IDS[0] += 1
    prog_name = ("train_step" if _TRAIN_STEP_IDS[0] == 1
                 else f"train_step#{_TRAIN_STEP_IDS[0] - 1}")
    registered = [False]
    update = getattr(optimizer, "_step_impl", optimizer.step)

    def run(*batch):
        loss = loss_fn(model, *batch)
        loss.backward()
        update()
        optimizer.clear_grad()
        return loss.detach()

    def step(*batch):
        if registered[0]:
            return run(*batch)
        from ..observability import metrics, xla_introspect
        if not metrics.enabled():       # retried at the next step
            return run(*batch)
        registered[0] = True
        try:
            counter = xla_introspect.count(prog_name, args=(
                batch, list(model.parameters()), list(model.buffers()),
                optimizer._accumulators, optimizer._master_weights))
            counter.__enter__()
        except Exception:  # noqa: BLE001 — telemetry never blocks a step
            return run(*batch)
        try:
            loss = run(*batch)
            counter.outputs = loss
        except BaseException as e:
            counter.__exit__(type(e), e, e.__traceback__)
            raise
        counter.__exit__(None, None, None)
        return loss

    step.program = prog_name
    return step


__all__ = ["compile_train_step"]
