"""Checkpoint / resume for policies and training state.

JAX twin of the reference's checkpointing (reference
behavioral_cloning_train.py:169-189 saves the whole torch module + the
normalization payload; SURVEY.md §5.4). Here policies are Flax param pytrees
saved via orbax (with a numpy .npz fallback), always together with the
normalization stats and the network hyperparameters so a checkpoint is
self-describing — and unlike the reference, optimizer state and loop
counters can be checkpointed too (elastic resume of the learning loop, which
the reference lacks, SURVEY.md §5.3)."""

from __future__ import annotations

import json
import os

import jax
import numpy as np

from ..learning.networks import GoalConditionedPolicyNet, PolicyBundle


def save_policy(bundle: PolicyBundle, path: str):
    os.makedirs(path, exist_ok=True)
    meta = {
        "output_size": bundle.module.output_size,
        "num_hidden_layer": bundle.module.num_hidden_layer,
        "hidden_dim": bundle.module.hidden_dim,
        "batch_norm": bundle.module.batch_norm,
    }
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    flat = {
        f"param::{'/'.join(map(str, k))}": np.asarray(v)
        for k, v in jax.tree_util.tree_flatten_with_path(bundle.params)[0]
    }
    def _stat(v):
        # python-float stats (e.g. goal_mean=0.0) would round-trip as float64
        # and silently promote the whole policy (and any jitted rollout carry
        # that consumes its actions) to f64 under x64 — pin the framework dtype
        a = np.asarray(v)
        return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a

    np.savez_compressed(
        os.path.join(path, "payload.npz"),
        state_mean=_stat(bundle.state_mean),
        state_std=_stat(bundle.state_std),
        goal_mean=_stat(bundle.goal_mean),
        goal_std=_stat(bundle.goal_std),
        **flat,
    )


def load_policy(path: str) -> PolicyBundle:
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    z = np.load(os.path.join(path, "payload.npz"))
    module = GoalConditionedPolicyNet(**meta)
    params = {}
    for key in z.files:
        if not key.startswith("param::"):
            continue
        parts = key[len("param::") :].split("/")
        node = params
        for p in parts[:-1]:
            p = _clean(p)
            node = node.setdefault(p, {})
        node[_clean(parts[-1])] = z[key]
    import jax.numpy as jnp

    def _stat(a):
        # guard against f64 stats in pre-existing checkpoints (see save_policy)
        return jnp.asarray(
            a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a
        )

    return PolicyBundle(
        module=module,
        params=params,
        state_mean=_stat(z["state_mean"]),
        state_std=_stat(z["state_std"]),
        goal_mean=_stat(z["goal_mean"]),
        goal_std=_stat(z["goal_std"]),
    )


def _clean(part: str) -> str:
    # tree_flatten_with_path renders dict keys as "['name']"
    return part.strip("[]'\"")


def save_train_state(path: str, params, opt_state, step: int, extra: dict | None = None):
    """Mid-training checkpoint via orbax (optimizer state included)."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(
        os.path.abspath(path),
        {"params": params, "opt_state": opt_state, "step": step, "extra": extra or {}},
        force=True,
    )
    ckptr.wait_until_finished()


def load_train_state(path: str, template):
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path), template)
