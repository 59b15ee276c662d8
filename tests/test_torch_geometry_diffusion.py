"""Parity of the PyTorch port's geometry and diffusion kernels with the JAX
package, on the CPU in float32.

Random draws differ between the frameworks, so the port is fed the very
numbers the JAX functions draw from their keys (the same split and the
same jax.random calls), and the results are compared element-wise.
Tolerance: 1e-5 for float32 elementwise math (transcendentals round
differently in the last bits), exact equality for tables built by the same
float64 numpy code and for sampled sequences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffab_pytorch_tpu.diffusion import coordinate as jcoord
from diffab_pytorch_tpu.diffusion import orientation as jorient
from diffab_pytorch_tpu.diffusion import sequence as jseq
from diffab_pytorch_tpu.diffusion.schedule import cosine_variance_schedule as jsched
from diffab_pytorch_tpu.geometry import igso3 as jigso3
from diffab_pytorch_tpu.geometry import so3 as jso3

from diffab_pytorch_tpu_torch.diffusion import coordinate as tcoord
from diffab_pytorch_tpu_torch.diffusion import orientation as torient
from diffab_pytorch_tpu_torch.diffusion import sequence as tseq
from diffab_pytorch_tpu_torch.diffusion.schedule import cosine_variance_schedule as tsched
from diffab_pytorch_tpu_torch.geometry import igso3 as tigso3
from diffab_pytorch_tpu_torch.geometry import so3 as tso3

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T, B, L = 8, 3, 10


def t_(a):
    return torch.from_numpy(np.array(a))


def close(actual, expected, atol=1e-5):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), atol=atol, rtol=1e-5)


def igso3_draw(key, out_shape):
    """The numbers jax igso3.sample_axis_angle(key, ...) draws."""
    k_axis, k_theta = jax.random.split(key)
    k_bin, k_gauss = jax.random.split(k_theta)
    return tigso3.AxisAngleNoise(
        axis=t_(jax.random.normal(k_axis, out_shape + (3,))),
        uniform=t_(jax.random.uniform(k_bin, out_shape)),
        normal=t_(jax.random.normal(k_gauss, out_shape)),
    )


@pytest.fixture(scope="module")
def scheds():
    return jsched(T, s=0.01), tsched(T, s=0.01)


@pytest.fixture(scope="module")
def tables(scheds):
    js, ts = scheds
    return jorient.make_orientation_tables(js), torient.make_orientation_tables(ts)


def _rotations():
    """Random rotations plus theta ~ 0 and theta ~ pi (the log map's
    singular points for the textbook formula)."""
    r = np.array(jso3.uniform(jax.random.key(0), (16,)))
    axis = np.random.default_rng(0).normal(size=(4, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angles = np.array([0.0, 1e-7, np.pi - 1e-6, np.pi])[:, None]
    special = np.array(jso3.vector_to_rotation_matrix(jnp.asarray(axis * angles, jnp.float32)))
    return np.concatenate([r, special]).astype(np.float32)


def test_so3_log_exp_and_scale_match_jax():
    r = _rotations()
    v_j = np.asarray(jso3.rotation_matrix_to_vector(jnp.asarray(r)))
    v_t = tso3.rotation_matrix_to_vector(t_(r))
    # near theta = pi the axis sign is a convention, so compare the rotations
    close(tso3.vector_to_rotation_matrix(v_t), r, atol=2e-5)
    close(v_t[:-2], v_j[:-2], atol=2e-5)
    close(tso3.matrix_to_quaternion(t_(r)), jso3.matrix_to_quaternion(jnp.asarray(r)))
    close(tso3.vector_to_rotation_matrix(t_(v_j)),
          jso3.vector_to_rotation_matrix(jnp.asarray(v_j)))
    k = np.linspace(0.0, 1.0, r.shape[0]).astype(np.float32)
    close(tso3.scale_rot(t_(r), t_(k)), jso3.scale_rot(jnp.asarray(r), jnp.asarray(k)),
          atol=3e-5)
    assert torch.isfinite(tso3.log_rotmat(t_(r))).all()


def test_so3_uniform_with_injected_normals_matches_jax():
    key = jax.random.key(4)
    normal = jax.random.normal(key, (B, L, 4))
    close(tso3.uniform((B, L), normal=t_(normal)), jso3.uniform(key, (B, L)))


def test_schedule_matches_jax(scheds):
    js, ts = scheds
    for a, b in zip(js, ts):
        close(b, a, atol=0)


def test_igso3_tables_equal_jax(tables):
    jt, tt = tables
    for a, b in zip(jt.igso3, tt.igso3):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_axis_angle_sampling_with_injected_draws_matches_jax(tables):
    """Every timestep of the table: t = 1 is the inverse-CDF branch, larger
    t the folded-Gaussian branch."""
    jt, tt = tables
    sigma_idx = np.arange(T + 1)
    key = jax.random.key(5)
    v_j = jigso3.sample_axis_angle(key, jt.igso3, jnp.asarray(sigma_idx), (L,))
    v_t = tigso3.sample_axis_angle(tt.igso3, t_(sigma_idx), (L,),
                                   noise=igso3_draw(key, (T + 1, L)))
    assert bool(np.asarray(jt.igso3.use_hist).any()) and not bool(np.asarray(jt.igso3.use_hist).all())
    close(v_t, v_j)


def _state(seed):
    rng = np.random.default_rng(seed)
    gen = np.zeros((B, L), bool)
    gen[:, 3:8] = True
    return dict(
        t=rng.integers(1, T + 1, B),
        seq=rng.integers(0, 21, (B, L)),
        probs=rng.dirichlet(np.ones(21), (B, L)).astype(np.float32),
        x=rng.normal(size=(B, L, 3)).astype(np.float32),
        eps=rng.normal(size=(B, L, 3)).astype(np.float32),
        r=np.array(jso3.uniform(jax.random.key(seed), (B, L))),
        r0=np.array(jso3.uniform(jax.random.key(seed + 1), (B, L))),
        gen=gen,
    )


def test_sequence_posterior_and_draw_match_jax(scheds):
    js, ts = scheds
    s = _state(1)
    jargs = (jnp.asarray(s["seq"], jnp.int32), jnp.asarray(s["probs"]),
             jnp.asarray(s["t"], jnp.int32), jnp.asarray(s["gen"]))
    targs = (t_(s["seq"]), t_(s["probs"]), t_(s["t"]), t_(s["gen"]))
    close(tseq.posterior_from_predicted_t0(ts, *targs),
          jseq.posterior_from_predicted_t0(js, *jargs), atol=1e-6)
    key = jax.random.key(6)
    out_j = jseq.reverse_step(key, js, *jargs)
    gumbel = jax.random.gumbel(key, (B, L, 21))
    out_t = tseq.reverse_step(ts, *targs, gumbel=t_(gumbel))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    # the prior keeps context and draws in [0, K) on generated positions
    prior = tseq.sample_prior(targs[0], targs[3], 21, generator=torch.Generator().manual_seed(0))
    assert torch.equal(prior[~targs[3]], targs[0][~targs[3]])
    assert int(prior.max()) < 21


@pytest.mark.parametrize("clip", [None, "per_sample"])
def test_coordinate_reverse_step_matches_jax(scheds, clip):
    js, ts = scheds
    s = _state(2)
    x0_clip = None if clip is None else np.array([0.5, 2.0, 50.0], np.float32)
    jclip = None if clip is None else jnp.asarray(x0_clip)
    tclip = None if clip is None else t_(x0_clip)
    jargs = (jnp.asarray(s["x"]), jnp.asarray(s["eps"]), jnp.asarray(s["t"], jnp.int32),
             jnp.asarray(s["gen"]))
    targs = (t_(s["x"]), t_(s["eps"]), t_(s["t"]), t_(s["gen"]))
    key = jax.random.key(7)
    # deterministic posterior mean
    close(tcoord.reverse_step(ts, *targs, x0_clip=tclip, noise_scale=0.0),
          jcoord.reverse_step(key, js, *jargs, x0_clip=jclip, noise_scale=0.0))
    # with noise: the port gets the normal draw of the JAX key
    z = jax.random.normal(key, (B, L, 3))
    close(tcoord.reverse_step(ts, *targs, x0_clip=tclip, noise=t_(z)),
          jcoord.reverse_step(key, js, *jargs, x0_clip=jclip))
    close(tcoord.predicted_x0(ts, *targs[:3]), jcoord.predicted_x0(js, *jargs[:3]))


@pytest.mark.parametrize("noise_scale", [0.0, 1.0])
def test_orientation_reverse_step_matches_jax(tables, noise_scale):
    jt, tt = tables
    s = _state(3)
    key = jax.random.key(8)
    out_j = jorient.reverse_step(
        key, jt, jnp.asarray(s["r"]), jnp.asarray(s["r0"]), jnp.asarray(s["t"], jnp.int32),
        jnp.asarray(s["gen"]), noise_scale=noise_scale)
    out_t = torient.reverse_step(
        tt, t_(s["r"]), t_(s["r0"]), t_(s["t"]), t_(s["gen"]),
        noise_scale=noise_scale, noise=igso3_draw(key, (B, L)))
    close(out_t, out_j, atol=3e-5)
    # the posterior mode, given the same draw (its continuous-sigma sampler
    # splits the key as the renoise mode's does)
    out_j = jorient.reverse_step(
        key, jt, jnp.asarray(s["r"]), jnp.asarray(s["r0"]), jnp.asarray(s["t"], jnp.int32),
        jnp.asarray(s["gen"]), noise_scale=noise_scale, mode="posterior")
    out_t = torient.reverse_step(
        tt, t_(s["r"]), t_(s["r0"]), t_(s["t"]), t_(s["gen"]), noise_scale=noise_scale,
        mode="posterior", noise=igso3_draw(key, (B, L)))
    close(out_t, out_j, atol=3e-5)
    with pytest.raises(ValueError):
        torient.reverse_step(tt, t_(s["r"]), t_(s["r0"]), t_(s["t"]), t_(s["gen"]),
                             mode="geodesic")
