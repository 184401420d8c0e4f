"""Offline Raibert contact planner — the expert cc-goal generator.

JAX twin of the reference ``ContactPlanner`` (reference
examples/iterative_algorithm/contact_planner.py:9-257): produce the *desired*
long-horizon contact plan and contact schedule for a commanded velocity,
which the cc-conditioned policy is trained/evaluated against. Reuses the
vectorized gait machinery from ``mpc.gait`` over the episode-length horizon
(one call instead of the reference's horizon x feet Python loop).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..kin import algorithms as K
from ..mpc import gait as G
from ..mpc.kino_dyn import CyclicMpcSpec
from .goals import construct_contact_schedule


class ContactPlanner:
    def __init__(self, spec: CyclicMpcSpec, sim_dt: float = 0.001):
        self.spec = spec
        self.sim_dt = sim_dt

    def get_raibert_contact_plan(self, q0, v0, v_des, w_des, episode_length, start_time):
        """(contact_planner.py:61-234). Horizon uses the reference's x20
        buffer formula (:129-130)."""
        p = self.spec.params
        horizon = int(
            20.0 * episode_length * self.sim_dt * p.gait_horizon * p.gait_period / p.gait_dt
        )
        q0 = jnp.asarray(q0)
        com = K.com(self.spec.model, q0)
        ee = K.frame_positions(self.spec.model, q0, self.spec.eff_frames)
        plan, swing = G.create_cnt_plan(
            self.spec.gait,
            self.spec.planner,
            horizon,
            q0,
            jnp.asarray(float(start_time)),
            jnp.asarray(v_des, q0.dtype),
            jnp.asarray(float(w_des), q0.dtype),
            com,
            ee,
        )
        cnt_plan = np.concatenate(
            [np.asarray(plan.cnt)[..., None], np.asarray(plan.r)], axis=-1
        )
        return cnt_plan, np.asarray(swing)

    def get_switches(self, cnt_plan, start_step=0.0):
        """Swing->stance transitions as [ee, step, x, y, z]; z hard-coded to
        1e-3 like the reference (contact_planner.py:53)."""
        p = self.spec.params
        out = []
        for i in range(1, len(cnt_plan)):
            for ee in range(cnt_plan.shape[1]):
                if cnt_plan[i, ee, 0] == 1 and cnt_plan[i - 1, ee, 0] == 0:
                    step = start_step + i * p.gait_dt / self.sim_dt
                    out.append([ee, step, cnt_plan[i, ee, 1], cnt_plan[i, ee, 2], 1e-3])
        return np.asarray(out) if out else np.zeros((0, 5))

    def get_contact_schedule(self, q0, v0, v_des, w_des, episode_length, start_time):
        """(contact_planner.py:236-257)."""
        cnt_plan, _ = self.get_raibert_contact_plan(
            q0, v0, v_des, w_des, episode_length, start_time
        )
        switches = self.get_switches(cnt_plan, start_time / self.sim_dt)
        schedule = construct_contact_schedule(switches, len(self.spec.eff_frames))
        return schedule, cnt_plan
