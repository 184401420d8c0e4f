"""Behavioral-cloning trainer (Flax/Optax, mesh-sharded).

JAX twin of the reference BC trainers (reference
examples/iterative_algorithm/behavioral_cloning_train.py:35-244 and the
*_vc_policy / *_multi_database variants): L1 loss, Adam, train/val split,
periodic checkpoints of network + normalization payload. The torch DataLoader
+ single-GPU loop becomes a jitted train step whose batch axis is sharded
over the device mesh with a psum gradient reduction (data parallelism over
ICI — SURVEY.md §2.9/§5.8).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from .database import Database
from .networks import GoalConditionedPolicyNet, PolicyBundle


@dataclasses.dataclass
class BcConfig:
    """Reference defaults from cfgs/bc_config.yaml:84-88."""

    batch_size: int = 256
    learning_rate: float = 2e-3
    n_epoch: int = 150
    n_train_frac: float = 0.9
    num_hidden_layer: int = 3
    hidden_dim: int = 512
    loss: str = "l1"  # nn.L1Loss in the reference (:104)


def make_train_step(module, optimizer, loss_type: str = "l1"):
    @jax.jit
    def train_step(params, opt_state, x, y):
        def loss_fn(p):
            pred = module.apply({"params": p}, x)
            if loss_type == "l1":
                return jnp.mean(jnp.abs(pred - y))
            return jnp.mean((pred - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def make_sharded_train_step(module, optimizer, mesh, loss_type: str = "l1"):
    """Data-parallel train step over a mesh axis 'batch': inputs sharded over
    devices, gradients reduced with an implicit psum (jit + sharding
    annotations let XLA insert the all-reduce over ICI)."""
    xsh = NamedSharding(mesh, P("batch", None))
    repl = NamedSharding(mesh, P())

    @partial(
        jax.jit,
        in_shardings=(repl, repl, xsh, xsh),
        out_shardings=(repl, repl, repl),
    )
    def train_step(params, opt_state, x, y):
        def loss_fn(p):
            pred = module.apply({"params": p}, x)
            if loss_type == "l1":
                return jnp.mean(jnp.abs(pred - y))
            return jnp.mean((pred - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


@dataclasses.dataclass
class TrainReport:
    train_losses: list
    valid_losses: list


def train_policy(
    database: Database,
    cfg: BcConfig = BcConfig(),
    rng_seed: int = 0,
    mesh=None,
    params=None,
    log_fn: Callable | None = None,
) -> tuple[PolicyBundle, TrainReport]:
    """Train a goal-conditioned policy on the database (train_network,
    behavioral_cloning_train.py:83-167). Pass ``params`` to warm-start
    (DAgger-style continual training)."""
    x_all, y_all = database.xy()
    rng = np.random.default_rng(rng_seed)
    perm = rng.permutation(len(x_all))
    n_train = int(cfg.n_train_frac * len(x_all))
    tr, va = perm[:n_train], perm[n_train:]
    x_tr, y_tr = x_all[tr], y_all[tr]
    x_va, y_va = x_all[va], y_all[va]

    module = GoalConditionedPolicyNet(
        output_size=y_all.shape[-1],
        num_hidden_layer=cfg.num_hidden_layer,
        hidden_dim=cfg.hidden_dim,
    )
    if params is None:
        params = module.init(jax.random.PRNGKey(rng_seed), jnp.zeros((1, x_all.shape[-1])))[
            "params"
        ]
    optimizer = optax.adam(cfg.learning_rate)
    opt_state = optimizer.init(params)

    if mesh is not None:
        step = make_sharded_train_step(module, optimizer, mesh, cfg.loss)
        ndev = mesh.devices.size
        bs = max(cfg.batch_size // ndev * ndev, ndev)
    else:
        step = make_train_step(module, optimizer, cfg.loss)
        bs = cfg.batch_size

    eval_fn = jax.jit(lambda p, x: module.apply({"params": p}, x))
    train_losses, valid_losses = [], []
    n = (len(x_tr) // bs) * bs
    for epoch in range(cfg.n_epoch):
        perm = rng.permutation(len(x_tr))[:n]
        losses = []
        for i in range(0, n, bs):
            sel = perm[i : i + bs]
            params, opt_state, loss = step(params, opt_state, x_tr[sel], y_tr[sel])
            losses.append(float(loss))
        tl = float(np.mean(losses)) if losses else float("nan")
        if len(x_va):
            pred = np.asarray(eval_fn(params, x_va))
            vl = float(np.mean(np.abs(pred - y_va)))
        else:
            vl = float("nan")
        train_losses.append(tl)
        valid_losses.append(vl)
        if log_fn is not None:
            log_fn({"epoch": epoch, "Training Loss": tl, "Validation Loss": vl})

    sm, ss, gm, gs = database.get_database_mean_std()
    bundle = PolicyBundle(
        module=module,
        params=params,
        state_mean=jnp.asarray(sm),
        state_std=jnp.asarray(ss),
        goal_mean=jnp.asarray(gm) if not np.isscalar(gm) else gm,
        goal_std=jnp.asarray(gs) if not np.isscalar(gs) else gs,
    )
    return bundle, TrainReport(train_losses=train_losses, valid_losses=valid_losses)
