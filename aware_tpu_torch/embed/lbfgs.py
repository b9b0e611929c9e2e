"""L-BFGS for the embed solver: torch.optim.LBFGS's update as a host loop.

The port of ``aware_tpu/embed/lbfgs.py``, on torch tensors on the
solver's device.  Each solver iteration is one quasi-Newton iteration: the
trajectory of ``torch.optim.LBFGS([coeffs], lr, max_iter=1, history_size)``
driven by a closure once an iteration, with the solver's box clamp and
best snapshot between steps.  (The reference's own loop calls
``optimizer.step()`` without a closure, which LBFGS refuses, so torch's
update rule is the contract.)

Its curvature history grows and its exits depend on the data, so it is a
host loop: the two-loop recursion reads its dot products back to the host
as floats, as the JAX package's numpy loop does.  That is O(m) small
reads an iteration beside one value-and-grad of the objective.
"""

from __future__ import annotations

import dataclasses

import torch

# torch.optim.LBFGS's defaults (torch/optim/lbfgs.py)
TOLERANCE_GRAD = 1e-7
TOLERANCE_CHANGE = 1e-9
HISTORY_SIZE = 100


@dataclasses.dataclass
class LBFGSMemory:
    """The curvature history and last step, as torch's per-group state."""

    history_size: int = HISTORY_SIZE
    n_iter: int = 0
    old_dirs: list = dataclasses.field(default_factory=list)  # y_k
    old_stps: list = dataclasses.field(default_factory=list)  # s_k
    ro: list = dataclasses.field(default_factory=list)        # 1 / (y_k . s_k)
    h_diag: float = 1.0
    prev_flat_grad: torch.Tensor | None = None
    d: torch.Tensor | None = None
    t: float = 0.0


def lbfgs_update(mem: LBFGSMemory, params: torch.Tensor, grad: torch.Tensor,
                 lr: float) -> torch.Tensor:
    """One L-BFGS iteration (torch's branch without line search, at
    ``max_iter=1``) of flat params: returns the new params and updates
    ``mem``.

    torch's order and quirks are kept: the recorded step ``s = d * t``
    ignores any clamp applied between calls; the first step is
    ``min(1, 1 / sum|g|) * lr``; the direction and step are saved even
    when the descent guard skips the update."""
    g = grad.reshape(-1).to(params.dtype)
    if float(g.abs().max()) <= TOLERANCE_GRAD:
        return params  # torch returns before touching any state

    mem.n_iter += 1
    if mem.n_iter == 1:
        d = -g
        mem.old_dirs, mem.old_stps, mem.ro = [], [], []
        mem.h_diag = 1.0
    else:
        y = g - mem.prev_flat_grad
        s = mem.d * mem.t
        ys = float(y @ s)
        if ys > 1e-10:
            if len(mem.old_dirs) == mem.history_size:
                mem.old_dirs.pop(0)
                mem.old_stps.pop(0)
                mem.ro.pop(0)
            mem.old_dirs.append(y)
            mem.old_stps.append(s)
            mem.ro.append(1.0 / ys)
            mem.h_diag = ys / float(y @ y)
        num_old = len(mem.old_dirs)
        al = [0.0] * num_old
        q = -g
        for i in range(num_old - 1, -1, -1):
            al[i] = float(mem.old_stps[i] @ q) * mem.ro[i]
            q = q - al[i] * mem.old_dirs[i]
        r = q * mem.h_diag
        for i in range(num_old):
            be_i = float(mem.old_dirs[i] @ r) * mem.ro[i]
            r = r + (al[i] - be_i) * mem.old_stps[i]
        d = r

    mem.prev_flat_grad = g.clone()
    t = min(1.0, 1.0 / float(g.abs().sum())) * lr if mem.n_iter == 1 else lr
    gtd = float(g @ d)
    mem.d, mem.t = d, t
    if gtd > -TOLERANCE_CHANGE:
        return params  # not a descent direction; the state is kept
    return params + t * d
