"""The port's Stage-I discriminator and WGAN-GP losses against the JAX
package's, in f32 on the CPU: D1's ``features`` (eval and training mode,
with the BatchNorm statistics it updates), ``score`` and the whole
critic; ``gradient_penalty_aux`` with the same eps, its BatchNorm update,
and its gradient in the critic's parameters (the second-order term);
``kl_term`` in both modes and the two WGAN losses.

Tolerance: rtol = atol = 1e-5 for forwards and losses, 1e-4 for the
second-order parameter gradient (a gradient of a gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from imagegenerator_tpu.models import stackgan as jmodels
from imagegenerator_tpu.train import losses as jlosses
from imagegenerator_tpu_torch import convert
from imagegenerator_tpu_torch.models import stackgan as tmodels
from imagegenerator_tpu_torch.train import losses
from tests.test_torch_layers import flat_variables, nhwc, to_flax_variables

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
B, TEM, ND = 4, 32, 16


def _d1(channels=(12, 24), seed=0):
    rng = np.random.default_rng(seed)
    res = 2 ** (len(channels) + 2)
    img = np.tanh(rng.standard_normal((B, res, res, 3))).astype(np.float32)
    tem = rng.standard_normal((B, TEM)).astype(np.float32)
    jd = jmodels.StageIDiscriminator(tem_size=TEM, nd=ND, channels=channels)
    variables = jd.init(jax.random.key(seed), jnp.asarray(img), jnp.asarray(tem), train=False)
    flat = flat_variables(variables, rng)
    td = tmodels.StageIDiscriminator(TEM, ND, channels)
    convert.load_numpy(td, flat)
    return jd, to_flax_variables(flat), td, img, tem


def _stats(variables):
    return {"/".join(k): np.asarray(v) for k, v in
            traverse_util.flatten_dict(dict(variables["batch_stats"])).items()}


def _port_stats(td):
    return {k.split("/", 1)[1]: v for k, v in convert.to_numpy(td).items() if k.startswith("batch_stats/")}


@pytest.mark.parametrize("channels", [(12, 24), (8, 16, 24)])
def test_d1_features_score_and_call(channels):
    jd, variables, td, img, tem = _d1(channels)
    ji, jt = jnp.asarray(img), jnp.asarray(tem)
    ti, tt = torch.from_numpy(img), torch.from_numpy(tem)
    td.eval()
    with torch.no_grad():
        feat = td.features(ti)
        assert feat.shape == (B, channels[-1], 4, 4)
        want = jd.apply(variables, ji, train=False, method=jmodels.StageIDiscriminator.features)
        np.testing.assert_allclose(nhwc(feat), np.asarray(want), **TOL)
        want_score = jd.apply(variables, want, jt, method=jmodels.StageIDiscriminator.score)
        np.testing.assert_allclose(td.score(feat, tt).numpy(), np.asarray(want_score), **TOL)
        np.testing.assert_allclose(td(ti, tt).numpy(), np.asarray(jd.apply(variables, ji, jt, train=False)), **TOL)
    td.train()
    with torch.no_grad():
        feat = td.features(ti)
    want, mut = jd.apply(variables, ji, train=True, method=jmodels.StageIDiscriminator.features,
                         mutable=["batch_stats"])
    np.testing.assert_allclose(nhwc(feat), np.asarray(want), **TOL)
    got_stats, want_stats = _port_stats(td), _stats(mut)
    assert set(got_stats) == set(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, err_msg=k, **TOL)


def test_head_flattens_in_nhwc_order():
    """A feature map that differs only in position changes the score as
    JAX's (h, w, c) flatten does, not as an NCHW flatten would."""
    jd, variables, td, img, tem = _d1()
    feat = np.random.default_rng(1).standard_normal((B, 4, 4, 24)).astype(np.float32)
    want = jd.apply(variables, jnp.asarray(feat), jnp.asarray(tem), method=jmodels.StageIDiscriminator.score)
    got = td.score(torch.from_numpy(np.ascontiguousarray(feat.transpose(0, 3, 1, 2))), torch.from_numpy(tem))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_gradient_penalty_and_its_second_order_param_gradient():
    jd, variables, td, real, tem = _d1(seed=2)
    fake = np.tanh(np.random.default_rng(3).standard_normal(real.shape)).astype(np.float32)
    key = jax.random.key(5)
    eps = jax.random.uniform(key, (B, 1, 1, 1), dtype=jnp.float32)
    jt = jnp.asarray(tem)

    def jax_gp(params):
        def critic(images):
            scores, mut = jd.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   images, jt, train=True, mutable=["batch_stats"])
            return scores.reshape(-1), mut
        return jlosses.gradient_penalty_aux(critic, jnp.asarray(real), jnp.asarray(fake), key)

    (want_gp, want_mut), want_grads = jax.value_and_grad(jax_gp, has_aux=True)(variables["params"])

    td.train()
    tt = torch.from_numpy(tem)
    gp, aux = losses.gradient_penalty_aux(
        lambda images: (td(images, tt).reshape(-1), "aux"),
        torch.from_numpy(real), torch.from_numpy(fake), eps=torch.from_numpy(np.array(eps)),
    )
    assert aux == "aux"
    np.testing.assert_allclose(gp.item(), float(want_gp), **TOL)
    got_stats, want_stats = _port_stats(td), _stats(want_mut)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, err_msg=k, **TOL)
    gp.backward()
    want_flat = {"params/" + "/".join(k): np.asarray(v)
                 for k, v in traverse_util.flatten_dict(dict(want_grads)).items()}
    params = dict(td.named_parameters())
    checked = 0
    for key_, flat_key, layout in convert.entries(td):
        if key_ in params:
            grad = params[key_].grad  # None where the penalty does not reach (the text path)
            got = convert._LAYOUTS[layout][1]((torch.zeros_like(params[key_]) if grad is None else grad).numpy())
            np.testing.assert_allclose(got, want_flat[flat_key], rtol=1e-4, atol=1e-4, err_msg=flat_key)
            checked += 1
    assert checked == len(want_flat)


def test_gradient_penalty_draws_eps_from_the_generator():
    real, fake = torch.zeros(3, 4, 4, 3), torch.ones(3, 4, 4, 3)
    seen = []

    def critic(images):
        seen.append(images.detach().clone())
        return images.sum(dim=(1, 2, 3)), None

    losses.gradient_penalty_aux(critic, real, fake, generator=torch.Generator().manual_seed(0))
    eps = torch.rand((3, 1, 1, 1), generator=torch.Generator().manual_seed(0))
    assert torch.equal(seen[0], (1 - eps).expand(3, 4, 4, 3))


@pytest.mark.parametrize("mode", ["correct", "faithful"])
def test_kl_and_wgan_losses(mode):
    rng = np.random.default_rng(6)
    mu, sigma = rng.standard_normal((2, 5, 8)).astype(np.float32)
    want = jlosses.kl_term(jnp.asarray(mu), jnp.asarray(sigma), mode)
    got = losses.kl_term(torch.from_numpy(mu), torch.from_numpy(sigma), mode)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    real, neg = rng.standard_normal(4).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(
        losses.wgan_critic_loss(torch.from_numpy(real), torch.from_numpy(neg)).item(),
        float(jlosses.wgan_critic_loss(jnp.asarray(real), jnp.asarray(neg))), **TOL)
    np.testing.assert_allclose(losses.wgan_generator_loss(torch.from_numpy(real)).item(),
                               float(jlosses.wgan_generator_loss(jnp.asarray(real))), **TOL)
    with pytest.raises(ValueError, match="kl_mode"):
        losses.kl_term(torch.from_numpy(mu), torch.from_numpy(sigma), "other")
