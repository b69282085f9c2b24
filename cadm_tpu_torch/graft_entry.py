"""The flagship model's forward step and the multi-rank dry run
(counterpart of the reference's root ``__graft_entry__.py``).

``entry(device)`` returns ``(fn, example_args)``: ``fn`` is one CaDM
ensemble forward step of ``parallel/dryrun.flagship()``'s model (2
probabilistic members with 4×200 heads, the context encoder over K=10
(Δobs, action) pairs), the member-stacked forward heads run as one batched
product and their next-obs predictions averaged over the members, on B=256
rows. ``dryrun_multichip`` is ``parallel/dryrun.py``'s.

    python -m cadm_tpu_torch.graft_entry     # on the card: entry, dry run
"""
from __future__ import annotations

import torch

from cadm_tpu_torch.core.types import resolve_device
from cadm_tpu_torch.parallel.dryrun import dryrun_multichip, flagship

__all__ = ["entry", "dryrun_multichip"]

B = 256


def entry(device="cuda"):
    """(fn, example_args): ``fn(params, norm, hist_dobs, hist_act,
    hist_valid, obs, act)`` → the member-mean next-obs prediction (B,
    obs_dim); the example args are the model's initial state (seed 0),
    zero histories and inputs, and all-valid windows."""
    device = resolve_device(device)
    trainer = flagship(device=device)
    env, model = trainer.env, trainer.model
    state = model.init_state(torch.Generator(device=device).manual_seed(0))
    k, n = model.cfg.history_k, model.cfg.n_members

    def fn(params, norm, hist_dobs, hist_act, hist_valid, obs, act):
        z = model.get_context(params, norm, hist_dobs, hist_act, hist_valid)
        preds = model.predict(params, norm, params["fwd"],
                              obs.expand(n, *obs.shape),
                              act.expand(n, *act.shape),
                              z.expand(n, *z.shape))
        return preds.mean(dim=0)

    example_args = (
        state.params,
        state.norm,
        torch.zeros(B, k, env.obs_dim, device=device),
        torch.zeros(B, k, env.act_dim, device=device),
        torch.ones(B, k, device=device),
        torch.zeros(B, env.obs_dim, device=device),
        torch.zeros(B, env.act_dim, device=device),
    )
    return fn, example_args


if __name__ == "__main__":
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
    dryrun_multichip(torch.cuda.device_count())
