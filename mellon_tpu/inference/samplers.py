"""Full posterior inference: HMC and NUTS, compiled for the device.

These are NEW capabilities relative to the reference (settylab/Mellon), whose
inference is MAP (scipy L-BFGS-B), ADVI and a diagonal Laplace approximation
(``mellon/inference.py:222-338, 768-876``); BASELINE.json's north star asks
for full NUTS/HMC over the latent GP function with chains sharded across
devices.

Design constraints driving the implementation:

* Everything is fixed-shape and jit-compiled: leapfrog integration under
  ``lax.scan``/``lax.while_loop``, NUTS tree building iterative (no
  recursion) with a per-depth checkpoint stack for the U-turn criterion, so
  one compiled program serves every step.
* Chains vectorize with ``vmap``; placing the chain axis of the initial state
  on a ``Mesh`` axis shards chains across devices (see
  :mod:`mellon_tpu.parallel`).
* Warmup follows Stan's windowed adaptation: dual-averaging step size plus
  diagonal (Welford) mass-matrix estimation.

The NUTS tree algorithm is the iterative formulation of Hoffman & Gelman's
No-U-Turn criterion with multinomial state sampling (Betancourt 2017), using
the power-of-two checkpoint scheme to test all properly-aligned subtrees.
"""

import logging
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

logger = logging.getLogger("mellon_tpu")


# ---------------------------------------------------------------------------
# leapfrog
# ---------------------------------------------------------------------------

class IntegratorState(NamedTuple):
    z: jnp.ndarray
    r: jnp.ndarray
    potential: jnp.ndarray
    grad: jnp.ndarray


def _leapfrog(potential_fn, inv_mass_diag, step_size, state):
    z, r, _, grad = state
    r = r - 0.5 * step_size * grad
    z = z + step_size * inv_mass_diag * r
    potential, grad = jax.value_and_grad(potential_fn)(z)
    r = r - 0.5 * step_size * grad
    return IntegratorState(z, r, potential, grad)


def _kinetic(inv_mass_diag, r):
    return 0.5 * jnp.sum(jnp.square(r) * inv_mass_diag)


# ---------------------------------------------------------------------------
# HMC kernel
# ---------------------------------------------------------------------------

class HMCState(NamedTuple):
    z: jnp.ndarray
    potential: jnp.ndarray
    grad: jnp.ndarray


class HMCInfo(NamedTuple):
    accept_prob: jnp.ndarray
    diverging: jnp.ndarray
    num_steps: jnp.ndarray
    energy: jnp.ndarray


def hmc_init(potential_fn, z0):
    potential, grad = jax.value_and_grad(potential_fn)(z0)
    return HMCState(z0, potential, grad)


def hmc_kernel(potential_fn, num_steps=32, divergence_threshold=1000.0):
    """Fixed-trajectory-length HMC with Metropolis correction."""

    def step(state, key, step_size, inv_mass_diag):
        key_mom, key_accept = jax.random.split(key)
        r0 = jax.random.normal(key_mom, state.z.shape) / jnp.sqrt(inv_mass_diag)
        energy0 = state.potential + _kinetic(inv_mass_diag, r0)

        init = IntegratorState(state.z, r0, state.potential, state.grad)
        integ = partial(_leapfrog, potential_fn, inv_mass_diag, step_size)
        final = jax.lax.fori_loop(0, num_steps, lambda i, s: integ(s), init)

        energy1 = final.potential + _kinetic(inv_mass_diag, final.r)
        delta = energy1 - energy0
        delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
        diverging = delta > divergence_threshold
        accept_prob = jnp.clip(jnp.exp(-delta), max=1.0)
        accept = jax.random.uniform(key_accept) < accept_prob
        new_state = HMCState(final.z, final.potential, final.grad)
        state = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), new_state, state
        )
        info = HMCInfo(accept_prob, diverging, jnp.asarray(num_steps), energy1)
        return state, info

    return step


# ---------------------------------------------------------------------------
# NUTS kernel (iterative, multinomial)
# ---------------------------------------------------------------------------

class _TreeState(NamedTuple):
    # proposal (multinomial-sampled state from the trajectory)
    z_proposal: jnp.ndarray
    potential_proposal: jnp.ndarray
    grad_proposal: jnp.ndarray
    # trajectory endpoints
    z_left: jnp.ndarray
    r_left: jnp.ndarray
    grad_left: jnp.ndarray
    potential_left: jnp.ndarray
    z_right: jnp.ndarray
    r_right: jnp.ndarray
    grad_right: jnp.ndarray
    potential_right: jnp.ndarray
    # running quantities
    r_sum: jnp.ndarray
    weight: jnp.ndarray          # logsumexp of -energy over trajectory
    turning: jnp.ndarray
    diverging: jnp.ndarray
    sum_accept_prob: jnp.ndarray
    num_steps: jnp.ndarray


def _is_turning(inv_mass_diag, r_left, r_right, r_sum):
    """Generalized U-turn criterion on the momentum sum."""
    v = inv_mass_diag * r_sum
    turn_left = jnp.sum(v * r_left) <= 0
    turn_right = jnp.sum(v * r_right) <= 0
    return turn_left | turn_right


def _leaf_checkpoint_idxs(n):
    """Checkpoint index range to test against for leaf n (0-based step index
    within a subtree).

    idx_max = number of set bits in (n >> 1); num = number of trailing set
    bits of n; the leaf must be tested against checkpoints
    idx_max - num + 1 .. idx_max.  This is the standard power-of-two scheme
    that makes the iterative tree equivalent to the recursive one.
    """

    def bit_count(x):
        def body(val):
            x, c = val
            return (x >> 1, c + (x & 1))

        _, count = jax.lax.while_loop(lambda v: v[0] > 0, body, (x, 0))
        return count

    def trailing_ones(x):
        def body(val):
            x, c = val
            return (x >> 1, c + 1)

        _, count = jax.lax.while_loop(lambda v: (v[0] & 1) != 0, body, (x, 0))
        return count

    idx_max = bit_count(n >> 1)
    num = trailing_ones(n)
    idx_min = idx_max - num + 1
    return idx_min, idx_max


def _iterative_turning_check(
    inv_mass_diag, leaf_idx, r, r_sum, r_ckpts, r_sum_ckpts
):
    """Check the new leaf against all properly-aligned checkpoint subtrees."""
    idx_min, idx_max = _leaf_checkpoint_idxs(leaf_idx)

    def body(state):
        i, _ = state
        subtree_r_sum = r_sum - r_sum_ckpts[i] + r_ckpts[i]
        turning = _is_turning(inv_mass_diag, r_ckpts[i], r, subtree_r_sum)
        return (i - 1, turning)

    def cond(state):
        i, turning = state
        return (i >= idx_min) & ~turning

    _, turning = jax.lax.while_loop(cond, body, (idx_max, False))
    return turning


def nuts_kernel(potential_fn, max_tree_depth=10, divergence_threshold=1000.0):
    """One NUTS transition: iterative tree doubling with multinomial sampling.

    Returns ``step(state, key, step_size, inv_mass_diag) -> (state, info)``.
    """

    def build_subtree(
        key, initial, depth, direction, step_size, inv_mass_diag, energy0, dim
    ):
        """Integrate 2**depth leapfrog steps in ``direction`` extending the
        trajectory, with per-depth checkpointing for the U-turn test."""
        num_leaves = 2**depth
        eps = jnp.where(direction > 0, step_size, -step_size)

        # start from the moving endpoint
        start = IntegratorState(
            jnp.where(direction > 0, initial.z_right, initial.z_left),
            jnp.where(direction > 0, initial.r_right, initial.r_left),
            jnp.where(direction > 0, initial.potential_right, initial.potential_left),
            jnp.where(direction > 0, initial.grad_right, initial.grad_left),
        )

        r_ckpts = jnp.zeros((max_tree_depth, dim))
        r_sum_ckpts = jnp.zeros((max_tree_depth, dim))

        def leaf_step(carry, leaf_idx):
            (state, sub_r_sum, sub_weight, z_prop, pot_prop, grad_prop,
             turning, diverging, sum_accept, r_ckpts, r_sum_ckpts, key) = carry
            key, key_sample = jax.random.split(key)

            state = _leapfrog(
                potential_fn, inv_mass_diag, eps, state
            )
            energy = state.potential + _kinetic(inv_mass_diag, state.r)
            energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
            delta = energy - energy0
            leaf_diverging = delta > divergence_threshold
            accept_prob = jnp.clip(jnp.exp(-delta), max=1.0)

            leaf_weight = -delta  # log weight relative to initial energy
            new_weight = jnp.logaddexp(sub_weight, leaf_weight)
            # progressive multinomial sampling within the subtree
            take = (
                jax.random.uniform(key_sample)
                < jnp.exp(leaf_weight - new_weight)
            )
            z_prop = jnp.where(take, state.z, z_prop)
            pot_prop = jnp.where(take, state.potential, pot_prop)
            grad_prop = jnp.where(take, state.grad, grad_prop)

            sub_r_sum = sub_r_sum + state.r

            # checkpointing: even leaves store, odd leaves test
            ckpt_i, ckpt_j = _leaf_checkpoint_idxs(leaf_idx)
            is_even = (leaf_idx % 2) == 0
            r_ckpts = jnp.where(
                is_even, r_ckpts.at[ckpt_j].set(state.r), r_ckpts
            )
            r_sum_ckpts = jnp.where(
                is_even, r_sum_ckpts.at[ckpt_j].set(sub_r_sum), r_sum_ckpts
            )
            leaf_turning = jnp.where(
                is_even,
                False,
                _iterative_turning_check(
                    inv_mass_diag, leaf_idx, state.r, sub_r_sum,
                    r_ckpts, r_sum_ckpts,
                ),
            )

            turning = turning | leaf_turning
            diverging = diverging | leaf_diverging
            sum_accept = sum_accept + accept_prob
            return (
                state, sub_r_sum, new_weight, z_prop, pot_prop, grad_prop,
                turning, diverging, sum_accept, r_ckpts, r_sum_ckpts, key,
            ), None

        init_carry = (
            start,
            jnp.zeros(dim),
            -jnp.inf,
            start.z,
            start.potential,
            start.grad,
            jnp.asarray(False),
            jnp.asarray(False),
            jnp.asarray(0.0),
            r_ckpts,
            r_sum_ckpts,
            key,
        )

        # the leaf count 2**depth is a traced value (depth is the doubling
        # loop counter), so the leaves run under while_loop with an early
        # exit on turning/divergence
        def loop_cond(val):
            leaf_idx, carry = val
            turning, diverging = carry[6], carry[7]
            return (leaf_idx < num_leaves) & ~turning & ~diverging

        def loop_body(val):
            leaf_idx, carry = val
            new_carry, _ = leaf_step(carry, leaf_idx)
            return leaf_idx + 1, new_carry

        _, carry = jax.lax.while_loop(loop_cond, loop_body, (0, init_carry))
        (state, sub_r_sum, sub_weight, z_prop, pot_prop, grad_prop,
         turning, diverging, sum_accept, _, _, _) = carry

        return (
            state, sub_r_sum, sub_weight, z_prop, pot_prop, grad_prop,
            turning, diverging, sum_accept, num_leaves,
        )

    def step(state, key, step_size, inv_mass_diag):
        dim = state.z.shape[0]
        key_mom, key_tree = jax.random.split(key)
        r0 = jax.random.normal(key_mom, (dim,)) / jnp.sqrt(inv_mass_diag)
        energy0 = state.potential + _kinetic(inv_mass_diag, r0)

        tree = _TreeState(
            z_proposal=state.z,
            potential_proposal=state.potential,
            grad_proposal=state.grad,
            z_left=state.z,
            r_left=r0,
            grad_left=state.grad,
            potential_left=state.potential,
            z_right=state.z,
            r_right=r0,
            grad_right=state.grad,
            potential_right=state.potential,
            r_sum=r0,
            weight=jnp.asarray(0.0),
            turning=jnp.asarray(False),
            diverging=jnp.asarray(False),
            sum_accept_prob=jnp.asarray(0.0),
            num_steps=jnp.asarray(0),
        )

        def cond(val):
            tree, depth, _ = val
            return (depth < max_tree_depth) & ~tree.turning & ~tree.diverging

        def body(val):
            tree, depth, key = val
            key, key_dir, key_sub, key_accept = jax.random.split(key, 4)
            direction = jnp.where(jax.random.uniform(key_dir) < 0.5, -1, 1)

            (end, sub_r_sum, sub_weight, z_prop, pot_prop, grad_prop,
             sub_turning, sub_diverging, sum_accept, n_leaves) = build_subtree(
                key_sub, tree, depth, direction, step_size, inv_mass_diag,
                energy0, dim,
            )

            # biased progressive sampling between old tree and new subtree
            take_new = (
                jnp.log(jax.random.uniform(key_accept))
                < sub_weight - tree.weight
            ) & ~sub_turning & ~sub_diverging
            z_proposal = jnp.where(take_new, z_prop, tree.z_proposal)
            potential_proposal = jnp.where(
                take_new, pot_prop, tree.potential_proposal
            )
            grad_proposal = jnp.where(take_new, grad_prop, tree.grad_proposal)

            new_r_sum = tree.r_sum + sub_r_sum
            # update the moved endpoint
            went_right = direction > 0
            z_left = jnp.where(went_right, tree.z_left, end.z)
            r_left = jnp.where(went_right, tree.r_left, end.r)
            grad_left = jnp.where(went_right, tree.grad_left, end.grad)
            potential_left = jnp.where(
                went_right, tree.potential_left, end.potential
            )
            z_right = jnp.where(went_right, end.z, tree.z_right)
            r_right = jnp.where(went_right, end.r, tree.r_right)
            grad_right = jnp.where(went_right, end.grad, tree.grad_right)
            potential_right = jnp.where(
                went_right, end.potential, tree.potential_right
            )

            # U-turn across the full (doubled) trajectory
            full_turning = _is_turning(inv_mass_diag, r_left, r_right, new_r_sum)

            tree = _TreeState(
                z_proposal=z_proposal,
                potential_proposal=potential_proposal,
                grad_proposal=grad_proposal,
                z_left=z_left,
                r_left=r_left,
                grad_left=grad_left,
                potential_left=potential_left,
                z_right=z_right,
                r_right=r_right,
                grad_right=grad_right,
                potential_right=potential_right,
                r_sum=new_r_sum,
                weight=jnp.logaddexp(tree.weight, sub_weight),
                turning=sub_turning | full_turning,
                diverging=sub_diverging,
                sum_accept_prob=tree.sum_accept_prob + sum_accept,
                num_steps=tree.num_steps + n_leaves,
            )
            return tree, depth + 1, key

        tree, depth, _ = jax.lax.while_loop(cond, body, (tree, 0, key_tree))

        # grad_proposal is threaded through the tree for exactly this hand-off
        # — recomputing value_and_grad here would add one leapfrog-equivalent
        # of wasted work per transition in the sampling hot loop
        new_state = HMCState(
            tree.z_proposal, tree.potential_proposal, tree.grad_proposal
        )
        accept_prob = tree.sum_accept_prob / jnp.maximum(tree.num_steps, 1)
        info = HMCInfo(
            accept_prob, tree.diverging, tree.num_steps,
            tree.potential_proposal,
        )
        return new_state, info

    return step


# ---------------------------------------------------------------------------
# warmup adaptation: dual averaging + diagonal Welford mass
# ---------------------------------------------------------------------------

class DualAveragingState(NamedTuple):
    log_step: jnp.ndarray
    log_step_avg: jnp.ndarray
    gradient_avg: jnp.ndarray
    t: jnp.ndarray
    mu: jnp.ndarray


def da_init(step_size):
    return DualAveragingState(
        jnp.log(step_size),
        jnp.log(step_size),
        jnp.asarray(0.0),
        jnp.asarray(0.0),
        jnp.log(10 * step_size),
    )


def da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    t = state.t + 1
    g = target - accept_prob
    gradient_avg = (1 - 1 / (t + t0)) * state.gradient_avg + g / (t + t0)
    log_step = state.mu - jnp.sqrt(t) / gamma * gradient_avg
    eta = t**-kappa
    log_step_avg = eta * log_step + (1 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, gradient_avg, t, state.mu)


class WelfordState(NamedTuple):
    mean: jnp.ndarray
    m2: jnp.ndarray
    count: jnp.ndarray


def welford_init(dim):
    return WelfordState(jnp.zeros(dim), jnp.zeros(dim), jnp.asarray(0.0))


def welford_update(state, x):
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(state, regularize=True):
    var = state.m2 / jnp.maximum(state.count - 1, 1)
    if regularize:
        # Stan's shrinkage towards unit variance
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var
