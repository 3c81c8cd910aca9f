"""Train step builder: loss and gradients, microbatch accumulation, AdamW.

Counterpart of :mod:`repro.train.train_step` on one device.  The
reference's ``mesh``, ``axes_tree``, ``rules`` and ``moe_impl`` arguments
place the step on a production mesh (FSDP / tensor-parallel shardings of
the params, the optimizer state and the batch); that LM sharding is not
ported, so neither are they, and ``jit_train_step`` (the reference's
``jax.jit`` with those shardings and donated buffers) has no counterpart:
the step updates the model and the optimizer state in place.
"""
from __future__ import annotations

import torch

from ..core.engine import resolve_device
from ..models.transformer import lm_loss, reference_leaves
from .optimizer import OptConfig, adamw_update


def make_train_step(model, opt_cfg: OptConfig, *, microbatches: int = 1,
                    remat: bool = True):
    """``step(opt_state, batch) -> metrics`` (``loss``, ``lr``,
    ``grad_norm``; 0-d tensors) for ``model`` (an
    :class:`repro_torch.models.LM` in its compute dtype; a CUDA model needs
    a card).

    The batch (NumPy or tensors, :func:`repro_torch.models.lm_loss`'s keys)
    is split along its first axis into ``microbatches`` equal parts; their
    gradients (``torch.autograd.grad``, never accumulated in ``.grad``) are
    summed into f32 buffers and divided by the count, their losses
    averaged, as the reference's accumulation scan does.  Then
    :func:`adamw_update` rewrites the model's weights and ``opt_state``,
    its int8 compression (``opt_cfg.int8_compress``) scaled over the
    reference's leaves (``transformer.reference_leaves``).
    """
    resolve_device(model.device)
    f32 = torch.float32
    leaves = reference_leaves(model.cfg, [n for n, _ in
                                          model.named_parameters()])

    def grads_of(params, batch):
        loss = lm_loss(model, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def step(opt_state, batch):
        params = dict(model.named_parameters())
        if microbatches > 1:
            B = next(iter(batch.values())).shape[0]
            assert B % microbatches == 0, \
                "microbatches must divide the global batch"
            mb = B // microbatches
            gsum = [torch.zeros(p.shape, dtype=f32, device=p.device)
                    for p in params.values()]
            lsum = torch.zeros((), dtype=f32, device=model.device)
            for j in range(microbatches):
                loss, grads = grads_of(params, {
                    k: v[j * mb:(j + 1) * mb] for k, v in batch.items()})
                torch._foreach_add_(gsum, grads)
                lsum = lsum + loss
                del grads
            grads = torch._foreach_div(gsum, microbatches)
            del gsum
            loss = lsum / microbatches
        else:
            loss, grads = grads_of(params, batch)
        metrics = adamw_update(params, dict(zip(params, grads)), opt_state,
                               opt_cfg, leaves=leaves)
        metrics["loss"] = loss
        return metrics

    return step
