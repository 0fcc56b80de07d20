"""quadruped_ctrl_tpu — a batched JAX quadruped locomotion control framework.

A from-scratch JAX/XLA re-design of the capabilities of
Derek-TH-Wang/quadruped_ctrl (MIT Mini-Cheetah ConvexMPC locomotion stack):

* single-rigid-body convex MPC over ground reaction forces (condensed dense
  formulation + batched ADMM QP solver),
* gait scheduling (11 offset/duration gaits + adaptive "aio" gait),
* Raibert foot placement + Bezier swing trajectories,
* orientation + linear-KF state estimation,
* leg-level torque mapping, safety checking,
* batched scenario simulation (SRB + point feet) and multi-chip sharding.

Everything per-robot is a pure function `(state, sensors, command, config) ->
(state, torques)`; batching is `jax.vmap`, scale-out is `shard_map` over a
device mesh. The whole control step is jittable with static shapes.
"""

__version__ = "0.1.0"

from quadruped_ctrl_tpu.config import FrameworkConfig, default_config  # noqa: F401
