"""The port's training loss and train step against the reference, f32 on
CPU.

diffusion_loss: the reference's draws (t, noise, offset from the key
split it makes) are fed to the port's loss; epsilon and v targets, min-SNR
gamma 5.0, a noise offset and per-example loss weights, within 1e-6
relative. The step:
make_train_step + adamw_cosine against the reference's (optax's
clip_by_global_norm + adamw over a warmup-cosine schedule) on the toy
quadratic of tests/test_train_step.py, with 4-way accumulation and EMA:
params, EMA and Adam moments within 1e-6, losses within 1e-6 relative;
the learning rates equal optax's schedules to 1e-6 relative (f32 there,
f64 here); accumulation over 4 microbatches equals one big batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdxl_tpu.pipeline.sampler import scaled_linear_alphas_cumprod
from sdxl_tpu.train.losses import diffusion_loss as j_diffusion_loss
from sdxl_tpu.train.step import TrainState as JTrainState
from sdxl_tpu.train.step import adamw_cosine as j_adamw_cosine
from sdxl_tpu.train.step import make_train_step as j_make_train_step
from sdxl_tpu_torch.train.losses import diffusion_loss
from sdxl_tpu_torch.train.step import TrainState, adamw_cosine, make_train_step

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)

ALPHAS = np.asarray(scaled_linear_alphas_cumprod(), np.float32)


def reference_draws(key, shape):
    """The draws the reference's diffusion_loss makes from its key."""
    k_t, k_n, k_off = jax.random.split(key, 3)
    b = shape[0]
    return {"t": np.array(jax.random.randint(k_t, (b,), 0, len(ALPHAS))),
            "noise": np.array(jax.random.normal(k_n, shape, jnp.float32)),
            "offset": np.array(jax.random.normal(
                k_off, (b, 1, 1, 1), jnp.float32))}


@pytest.mark.parametrize("prediction_type,snr_gamma,noise_offset,weighted", [
    ("epsilon", None, 0.0, False),
    ("v", None, 0.0, False),
    ("epsilon", 5.0, 0.0, False),
    ("v", 5.0, 0.1, False),
    ("epsilon", None, 0.05, True),
])
def test_diffusion_loss_matches_reference(prediction_type, snr_gamma,
                                          noise_offset, weighted):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    scale = np.float32(0.7)
    key = jax.random.PRNGKey(5)

    def j_apply(p, x_t, t, batch):
        return x_t * p + t[:, None, None, None].astype(jnp.float32) * 1e-3

    def apply(p, x_t, t, batch):
        return x_t * p + t[:, None, None, None].float() * 1e-3

    kw = dict(prediction_type=prediction_type, snr_gamma=snr_gamma,
              noise_offset=noise_offset)
    batch = {"latents": x0}
    if weighted:  # per-example weights: the caller's normalisation
        batch["loss_weight"] = np.array([0.5, 0.25, 0.125], np.float32)
    want = j_diffusion_loss(j_apply, scale, jnp.asarray(ALPHAS),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            key, **kw)
    draw = {k: torch.from_numpy(v) for k, v in
            reference_draws(key, x0.shape).items()}
    got = diffusion_loss(apply, torch.tensor(scale), torch.from_numpy(ALPHAS),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         draw, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_diffusion_loss_generator_draws():
    """With a generator the loss draws t in [0, N) and unit noise."""
    x0 = torch.zeros((64, 2, 2, 4))
    seen = {}

    def apply(p, x_t, t, batch):
        seen["t"], seen["x_t"] = t, x_t
        return torch.zeros_like(x_t)

    loss = diffusion_loss(apply, None, torch.from_numpy(ALPHAS),
                          {"latents": x0}, torch.Generator().manual_seed(0))
    assert 0 <= int(seen["t"].min()) and int(seen["t"].max()) < len(ALPHAS)
    assert 0.8 < float(loss) < 1.2  # E[noise^2] = 1


def toy_batches(n_steps, n=16, d=8):
    rng = np.random.default_rng(1)
    w_true = rng.standard_normal((d, 3)).astype(np.float32)
    out = []
    for _ in range(n_steps):
        x = rng.standard_normal((n, d)).astype(np.float32)
        out.append({"x": x, "y": x @ w_true})
    return out


def j_quad_loss(trainable, frozen, batch, key):
    return jnp.mean(jnp.square(batch["x"] @ trainable["w"] - batch["y"]))


def quad_loss(trainable, batch, draw):
    return torch.mean(torch.square(batch["x"] @ trainable["w"] - batch["y"]))


def micro(batch, accum):
    return {k: v.reshape((accum, -1) + v.shape[1:]) for k, v in batch.items()}


def test_train_step_matches_optax():
    """5 steps, accum 4, EMA 0.9, warmup 2 then cosine, weight decay, a
    clip that triggers: params, EMA and losses equal the reference's."""
    hp = dict(lr=0.05, steps=6, warmup=2, weight_decay=0.01, grad_clip=0.5)
    batches = [micro(b, 4) for b in toy_batches(5)]
    j_tx = j_adamw_cosine(**hp)
    j_state = JTrainState.create({"w": jnp.zeros((8, 3))}, j_tx, ema=True)
    j_step = jax.jit(j_make_train_step(j_quad_loss, j_tx, ema_decay=0.9,
                                       accum=4))
    tx = adamw_cosine(**hp)
    state = TrainState.create({"w": torch.zeros((8, 3))}, tx, ema=True)
    step = make_train_step(quad_loss, tx, ema_decay=0.9, accum=4)
    for batch in batches:
        j_state, j_loss = j_step(j_state, None, batch, jax.random.PRNGKey(0))
        state, loss = step(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, None)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
        for got, want in ((state.params, j_state.params),
                          (state.ema, j_state.ema),
                          (state.opt_state["mu"], j_state.opt_state[1][0].mu)):
            np.testing.assert_allclose(got["w"].numpy(),
                                       np.asarray(want["w"]), atol=1e-6,
                                       rtol=0)
    assert state.step == int(j_state.step) == 5


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(warmup):
    lr, steps, frac = 1e-4, 10, 0.1
    tx = adamw_cosine(lr, steps, warmup=warmup, final_lr_frac=frac)
    if warmup:
        sched = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup, max(steps, warmup + 1), end_value=lr * frac)
    else:
        sched = optax.cosine_decay_schedule(lr, steps, alpha=frac)
    got = [tx.schedule(i) for i in range(steps + 3)]
    want = [float(sched(i)) for i in range(steps + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_accum_equals_big_batch():
    tx = adamw_cosine(0.01, 4, grad_clip=None)
    batch = {k: torch.from_numpy(v) for k, v in toy_batches(1)[0].items()}
    s1, l1 = make_train_step(quad_loss, tx)(
        TrainState.create({"w": torch.zeros((8, 3))}, tx), batch, None)
    s4, l4 = make_train_step(quad_loss, tx, accum=4)(
        TrainState.create({"w": torch.zeros((8, 3))}, tx),
        {k: v.reshape((4, 4) + v.shape[1:]) for k, v in batch.items()},
        [None] * 4)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-6)
    np.testing.assert_allclose(s1.params["w"].numpy(), s4.params["w"].numpy(),
                               atol=1e-6)
