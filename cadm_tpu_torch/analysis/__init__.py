"""Analyses of trained-model snapshots (counterparts of the reference's
``scripts/probe_*.py`` and ``scripts/ab_ts1.py``).

Each module is named after its script and runs as
``python -m cadm_tpu_torch.analysis.<name>`` with the script's flags plus
``--device`` (default ``cuda``; it raises without a card). The probes read
the snapshots the matrix runner writes (``results/torch/ckpt/<cell>.pt``,
see ``snapshot``) and write the script's JSON keys under ``results/torch/``:

- ``probe_context``: linear decoding of the hidden physics from CaDM's z;
- ``probe_hstep``: open-loop H-step error and member spread against the
  real env;
- ``probe_blowup``: how often unguarded TS1 rollouts leave the healthy
  envelope;
- ``probe_dist``: one-step error on random vs planner-driven data;
- ``probe_epochs``: the epoch-cap audit of the recorded cells (JSON only);
- ``probe_ranges``: returns at pinned hidden scales under a random and a
  planner policy;
- ``ab_ts1``: block vs exact TS1 on a trained cartpole ensemble.

Every draw is injectable (start states, histories, actions, permutations,
sample indices), so a test can hand a probe the reference's own numbers.
"""
