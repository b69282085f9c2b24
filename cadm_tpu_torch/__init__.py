"""cadm_tpu_torch — the PyTorch/CUDA port of ``cadm_tpu`` for NVIDIA Hopper.

Module paths mirror ``cadm_tpu`` so each counterpart is easy to find
(``physics/rigid/dynamics.py``, ``envs/half_cheetah.py``,
``planners/mpc.py``, ...). Tensors are batch-first with a leading env axis,
the device is passed down explicitly from ``ExperimentConfig.build``, and
randomness comes from explicit ``torch.Generator``s.

The two TPU kernels on the acting path have hand-written CUDA counterparts
in ``csrc/`` (built with nvcc for sm_90a at first use, see ``ops/_build.py``):
the projected Gauss–Seidel contact solve (``ops/pgs.py``) and the fused
smooth-dynamics step (``ops/fk_kernel.py``). On CPU tensors each wrapper runs
its plain PyTorch version instead.

Importing this package imports nothing: it never needs jax, flax, optax or
mujoco (the rigid Systems ship as npz data under ``envs/assets/``).
"""
