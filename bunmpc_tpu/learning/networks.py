"""Policy networks (Flax).

JAX twin of the reference ``GoalConditionedPolicyNet`` (reference
examples/iterative_algorithm/networks.py:7-81): an MLP mapping
[state(43) ⊕ goal] -> action(12), ReLU, optional BatchNorm, Kaiming fan-in
init. Defaults mirror the reference (4 hidden layers x 256) and the BC config
(3 x 512, cfgs/bc_config.yaml).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
from flax import linen as nn


class GoalConditionedPolicyNet(nn.Module):
    output_size: int = 12
    num_hidden_layer: int = 4
    hidden_dim: int = 256
    batch_norm: bool = False

    @nn.compact
    def __call__(self, x, train: bool = False):
        kaiming = nn.initializers.kaiming_normal()
        for _ in range(self.num_hidden_layer):
            x = nn.Dense(self.hidden_dim, kernel_init=kaiming, bias_init=nn.initializers.zeros)(x)
            if self.batch_norm:
                x = nn.BatchNorm(use_running_average=not train)(x)
            x = nn.relu(x)
        return nn.Dense(self.output_size, kernel_init=kaiming, bias_init=nn.initializers.zeros)(x)


@dataclasses.dataclass
class PolicyBundle:
    """A trained policy + its input normalization payload — the twin of the
    reference's checkpoint dict {network, norm stats}
    (behavioral_cloning_train.py:169-189)."""

    module: GoalConditionedPolicyNet
    params: dict
    state_mean: jnp.ndarray
    state_std: jnp.ndarray
    goal_mean: jnp.ndarray | float
    goal_std: jnp.ndarray | float

    def __call__(self, state, goal):
        s = (state - self.state_mean) / self.state_std
        g = (goal - self.goal_mean) / self.goal_std
        x = jnp.concatenate([s, g], axis=-1)
        return self.module.apply({"params": self.params}, x)


def policy_tree(bundle: "PolicyBundle") -> dict:
    """The traced half of a PolicyBundle: params + normalization arrays as a
    plain pytree. Pass THIS through jit argument lists — closing over the
    bundle inside a jitted function bakes the weights as compile-time
    constants, so later calls silently reuse the first iteration's policy."""
    return {
        "params": bundle.params,
        "state_mean": bundle.state_mean,
        "state_std": bundle.state_std,
        "goal_mean": bundle.goal_mean,
        "goal_std": bundle.goal_std,
    }


def policy_fn_from_tree(module: GoalConditionedPolicyNet, tree: dict):
    """(state, goal) -> action closure over a traced policy pytree; the
    module (static architecture) is the only captured constant."""

    def fn(state, goal):
        s = (state - tree["state_mean"]) / tree["state_std"]
        g = (goal - tree["goal_mean"]) / tree["goal_std"]
        x = jnp.concatenate([s, g], axis=-1)
        return module.apply({"params": tree["params"]}, x)

    return fn


def init_policy(rng, input_size: int, output_size: int = 12, **kwargs):
    module = GoalConditionedPolicyNet(output_size=output_size, **kwargs)
    params = module.init(rng, jnp.zeros((1, input_size)))["params"]
    return module, params
