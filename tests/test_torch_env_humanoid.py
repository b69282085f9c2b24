"""slim_humanoid's ``step_phys`` against the JAX package's, three control
steps on the same numpy-drawn states (tests/torch_families_common.py). In a
file of its own: compiling the JAX reference's smooth stage at nv = 23 takes
~20 s on the CPU."""
from tests.torch_families_common import step_matches_jax


def test_step_phys_matches_jax():
    active = step_matches_jax("slim_humanoid")
    assert active.max() >= 2  # the contact solve does real work
