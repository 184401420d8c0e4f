"""bunmpc_tpu — a JAX/XLA framework with the
capabilities of the BUNMPC reference stack: batched biconvex whole-body MPC
(centroidal ADMM + kinematic DDP), in-graph quadruped simulation, and the
iterative safe-learning loop (BC / DAgger / SafeDAgger / LocoSafeDagger /
Bayesian goal search), scaled over device meshes."""

import jax as _jax

# Full-f32 matmul precision by default, so XLA does not run f32 dots in
# reduced precision (TF32 on the GPU, ~3 decimal digits). For this stack's
# small, ill-conditioned linear algebra (9x9 block-Thomas factors, Riccati
# Gauss-Newton blocks, FK chains feeding mm-scale residuals) reduced precision
# is a CORRECTNESS bug, not a performance trade: the ADMM diverges to NaN on
# Go2 and the kinematic DDP silently freezes. Matmul-heavy consumers that
# genuinely want reduced precision (e.g. large policy nets) can override
# per-call or with jax.default_matmul_precision(...).
_jax.config.update("jax_default_matmul_precision", "float32")

__version__ = "0.1.0"
