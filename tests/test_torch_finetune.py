"""The whole training slice: the port's encode + LoRA fine-tune against
the reference's ``_encode_items`` + ``finetune_lora``, f32 on CPU.

A tiny pipeline on both sides with the same weights (drawn in the
reference's tree layout, carried across by io/bridge.py): the UNet has a
transformer at level 0 with 64 channels and one 64-wide head, so on a
32x32 latent (256x256 images) its self-attentions see 1024 tokens and take
the flash route (K2 forward and K3 backward; their plain versions here,
the JAX kernels in interpret mode). Three seeded images are encoded, then
3 LoRA steps (rank 4, attn targets, AdamW, remat) run with the reference's
initial factors and its per-step draws injected (keys
fold_in(PRNGKey(seed + 2), i), split in 3), and the same batch indices
(numpy default_rng(seed + 1)).

Tolerances: latents 2e-3 (the reference's VAE-encode bound); contexts
1e-4 (CLIP); per-step losses 1e-4 relative; the step-0 first Adam moment
(0.1 x the clipped gradient) within 1e-3 of its largest magnitude; the
factors after 3 steps within 0.05 x lr, since Adam maps near-zero
gradients to updates of up to +-lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import sdxl_tpu.train.finetune as j_finetune
from sdxl_tpu.configs import AutoencoderConfig, DiffuserConfig
from sdxl_tpu.models.clip import init_clip
from sdxl_tpu.models.unet import init_unet
from sdxl_tpu.models.vae import init_autoencoder
from sdxl_tpu.pipeline.pipeline import SDXLPipeline as JPipeline
from sdxl_tpu.pipeline.sampler import scaled_linear_alphas_cumprod
from sdxl_tpu.tokenizer import ClipTokenizer, OpenClipTokenizer
from sdxl_tpu.train.lora import init_lora as j_init_lora
from sdxl_tpu_torch.io.bridge import (
    clip_state_dict,
    factors_to_numpy,
    factors_to_torch,
    unet_state_dict,
    vae_decoder_state_dict,
    vae_encoder_state_dict,
)
from sdxl_tpu_torch.ops import flash_attention as fa
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from sdxl_tpu_torch.train.finetune import (
    FinetuneConfig,
    _encode_items,
    finetune_lora,
    sample_batch,
)
from tests.test_torch_pipeline import TINY_EMBEDDER
from tests.test_torch_unet import random_tree

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)

DIFFUSER = DiffuserConfig(adm_in_channels=32 + 6 * 256, model_channels=64,
                          channel_mults=(1, 2), num_head_channels=64,
                          transformer_depths=(1, 1), context_dim=64,
                          transformer_levels=(0,))
VAE = AutoencoderConfig(encoder_channels=((8, 8), (8, 8), (8, 16), (16, 16)),
                        decoder_channels=((16, 16), (16, 8), (8, 8), (8, 8)),
                        n_group=4)
CAPTIONS = ["a red crab", "a (blue:1.2) crab on sand", "green crab"]
SEED, RANK, LR, STEPS = 0, 4, 1e-3, 3


@pytest.fixture(scope="module")
def pipes():
    emb = {"clip": random_tree(init_clip, TINY_EMBEDDER.clip_config, seed=1),
           "open_clip": random_tree(init_clip, TINY_EMBEDDER.open_clip_config,
                                    seed=2)}
    unet = jax.tree.map(np.asarray, random_tree(
        init_unet, DIFFUSER.unet_config(), jnp.float32, seed=3))
    vae = random_tree(init_autoencoder, VAE, seed=4, scale=0.05)
    jpipe = JPipeline(
        embedder_cfg=TINY_EMBEDDER, embedder_params=emb,
        diffuser_cfg=DIFFUSER, unet_params=unet,
        alphas_cumprod=jnp.asarray(scaled_linear_alphas_cumprod()),
        vae_cfg=VAE, vae_params=vae, clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32)
    tpipe = random_pipeline(device="cpu", embedder_cfg=TINY_EMBEDDER,
                            diffuser_cfg=DIFFUSER, vae_cfg=VAE,
                            unet_dtype=torch.float32, with_encoder=True)
    for k in ("clip", "open_clip"):
        tpipe.embedder[k].load_state_dict(clip_state_dict(emb[k]))
    tpipe.unet.load_state_dict(unet_state_dict(unet))
    tpipe.vae.load_state_dict(vae_decoder_state_dict(vae))
    tpipe.vae_encoder.load_state_dict(vae_encoder_state_dict(vae))
    return jpipe, tpipe


@pytest.fixture(scope="module")
def datasets(pipes, tmp_path_factory):
    jpipe, tpipe = pipes
    images = np.random.default_rng(5).integers(
        0, 256, (len(CAPTIONS), 256, 256, 3), dtype=np.uint8)
    d = tmp_path_factory.mktemp("images")
    items = []
    for i, (img, cap) in enumerate(zip(images, CAPTIONS)):
        Image.fromarray(img).save(d / f"img{i}.png")  # lossless
        items.append((str(d / f"img{i}.png"), cap))
    want = j_finetune._encode_items(jpipe, items, 256, chunk=2)
    got = _encode_items(tpipe, images, CAPTIONS, chunk=2)
    return want, got


def test_encoded_dataset_matches_reference(datasets):
    want, got = datasets
    assert got.latents.shape == want.latents.shape == (3, 32, 32, 4)
    np.testing.assert_allclose(got.latents, want.latents, atol=2e-3, rtol=0)
    for name in ("ctx", "label", "uncond_ctx", "uncond_label"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-4, rtol=0, err_msg=name)
    assert got.captions == want.captions


@pytest.mark.parametrize("batch_size,dropout", [(1, 0.0), (4, 0.5)])
def test_sample_batch_matches_reference(datasets, batch_size, dropout):
    """Same rng, same indices and caption dropout as the reference."""
    jdata, tdata = datasets
    want = j_finetune.sample_batch(jdata, batch_size,
                                   np.random.default_rng(9), dropout)
    got = sample_batch(tdata, batch_size, np.random.default_rng(9), dropout)
    assert sorted(got) == sorted(k for k in want if k in
                                 ("latents", "ctx", "label"))
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], atol=2e-3, rtol=0,
                                   err_msg=k)


def test_finetune_lora_matches_reference(pipes, datasets, monkeypatch):
    jpipe, tpipe = pipes
    jdata, tdata = datasets
    jcfg = j_finetune.FinetuneConfig(rank=RANK, steps=STEPS, lr=LR,
                                     seed=SEED, log_every=0)

    # the reference's run, with a spy on its jitted step: per-step loss,
    # key and batch, and the first Adam moment after step 0
    seen = {"loss": [], "key": [], "latents": []}
    run_loop = j_finetune._run_loop

    def spy_loop(step, *args, **kwargs):
        def spy(state, frozen, batch, key):
            state, loss = step(state, frozen, batch, key)
            seen["loss"].append(float(loss))
            seen["key"].append(key)
            seen["latents"].append(np.asarray(batch["latents"]))
            if len(seen["loss"]) == 1:
                seen["mu0"] = {k: np.array(v) for k, v in
                               state.opt_state[1][0].mu.items()}
            return state, loss
        return run_loop(spy, *args, **kwargs)

    monkeypatch.setattr(j_finetune, "_run_loop", spy_loop)
    want, _ = j_finetune.finetune_lora(jpipe, jdata, jcfg)

    draws = []
    for key, lat in zip(seen["key"], seen["latents"]):
        k_t, k_n, k_off = jax.random.split(key, 3)
        draws.append({
            "t": torch.from_numpy(np.array(jax.random.randint(
                k_t, (lat.shape[0],), 0, 1000))),
            "noise": torch.from_numpy(np.array(jax.random.normal(
                k_n, lat.shape, jnp.float32)))})
    init = j_init_lora(jpipe.unet_params, RANK, jax.random.PRNGKey(SEED))

    calls = {"lse": 0, "bwd": 0}
    lse_plain, bwd_plain = fa.flash_attention_lse_plain, fa.flash_attention_bwd_plain

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_lse_plain",
                        count("lse", lse_plain))
    monkeypatch.setattr(fa, "flash_attention_bwd_plain",
                        count("bwd", bwd_plain))
    got_loss, got_mu0 = [], {}

    def on_step(i, state, loss):
        got_loss.append(loss)
        if i == 0:
            got_mu0.update(factors_to_numpy(state.opt_state["mu"]))

    tcfg = FinetuneConfig(rank=RANK, steps=STEPS, lr=LR, seed=SEED,
                          log_every=0)
    got, ema = finetune_lora(tpipe, tdata, tcfg,
                             factors=factors_to_torch(init),
                             draws=lambda i: draws[i], on_step=on_step)
    got = factors_to_numpy(got)

    # 5 flash self-attentions per forward (2 down, 3 up at level 0), the
    # forward run twice per step under remat, the backward once
    assert calls == {"lse": 2 * 5 * STEPS, "bwd": 5 * STEPS}
    assert ema is None
    assert len(seen["loss"]) == len(got_loss) == STEPS
    np.testing.assert_allclose(got_loss, seen["loss"], rtol=1e-4)
    assert got_mu0.keys() == seen["mu0"].keys()
    for k, v in seen["mu0"].items():
        scale = max(np.abs(v).max(), 1e-12)
        np.testing.assert_allclose(got_mu0[k], v, atol=1e-3 * scale, rtol=0,
                                   err_msg=k)
    assert got.keys() == want.keys()
    moved = max(np.abs(got[k]).max() for k in got if k.endswith("lora_up"))
    assert moved > 0.5 * LR  # the ups left zero
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=0.05 * LR,
                                   rtol=0, err_msg=k)
