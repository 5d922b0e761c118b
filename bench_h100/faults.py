"""Faults planted under the timed path, to show that the correctness check
refuses them (tests/, and calibrate.py's upper readings of a train cell):

- ``unchanged``: a train step that leaves the state as it found it;
- ``half_batch``: the step sees the first half of each batch (the loss the
  mean over that half), eval outputs repeated to the batch's size;
- ``altered``: an answer altered where it is produced: one pixel of a
  step's pred set off by 1 (the whole range of a reflectance in [0, 1]);
- ``doubled``: a train step that moves one leaf (the largest) twice its
  update.
"""

from __future__ import annotations

import torch


class _Wrap:
    def __init__(self, system):
        self.system, self.kind = system, system.kind

    def params(self):
        return self.system.params()

    def first_moment(self):
        return self.system.first_moment()


class Unchanged(_Wrap):
    """The port's train step with its parameters, Adam's moments and count
    put back as they were."""

    def __call__(self, batch, gen):
        st = self.system.state
        tensors = (list(st.model.parameters()) + list(st.opt_state.mu.values())
                   + list(st.opt_state.nu.values()))
        saved, count = [t.detach().clone() for t in tensors], st.opt_state.count
        loss = self.system(batch, gen)
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        st.opt_state.count = count
        return loss


class HalfBatch(_Wrap):
    def __call__(self, batch, *args):
        half = {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()}
        out = self.system(half, *args)
        if isinstance(out, dict):
            return {k: torch.cat([v, v]) if v.dim() else v for k, v in out.items()}
        return out


class Altered(_Wrap):
    def __call__(self, batch, *args):
        out = dict(self.system(batch, *args))
        out["pred"] = out["pred"].clone()
        out["pred"][0, 0, 0, 0] += 1.0
        return out


class Doubled(_Wrap):
    """A train step that moves its largest leaf twice its update."""

    def __call__(self, batch, gen):
        params = self.system.params()
        name = max(params, key=lambda n: params[n].numel())
        before = params[name].detach().clone()
        out = self.system(batch, gen)
        with torch.no_grad():
            p = self.system.params()[name]
            p.add_(p - before)
        return out


FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch, "altered": Altered,
          "doubled": Doubled}
