"""The port's CLIP tower and LLaVA projector (models/clip.py,
tools/convert_clip.py) against the JAX package's, on the CPU.

The tower is tools/testmodel.random_clip_weights at the "nano" scale (the
JAX package's tests/test_llava.py shape: hidden 32, 3 layers, image 32,
patch 8), made from a seed without transformers. Both packages' writers
must write the same bytes, both readers read the same config and tensors,
the preprocessed pixels are bitwise equal (both call PIL), and the
embeddings agree within 1e-5 of max|JAX| for both GELU variants.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from pipeinfer_tpu.models import clip as j_clip
from pipeinfer_tpu.tools.convert_clip import write_mmproj as j_write
from pipeinfer_tpu_torch.models import clip as t_clip
from pipeinfer_tpu_torch.models.convert import clip_params_from_numpy
from pipeinfer_tpu_torch.tools import live_check as LC
from pipeinfer_tpu_torch.tools import testmodel
from pipeinfer_tpu_torch.tools.convert_clip import write_mmproj as t_write

torch.set_num_threads(1)

ENCODE_RTOL = 1e-5  # of max|JAX embedding|: two f32 matmul libraries' summation orders
ACTS = ["quick_gelu", "gelu"]


@pytest.fixture(scope="module", params=ACTS)
def mmproj(request, tmp_path_factory):
    """(path, JAX (params, cfg), port (params, cfg)) of a nano mmproj with
    the blocks' quick GELU or (use_gelu) tanh GELU."""
    path = testmodel.build_mmproj(tmp_path_factory.mktemp("clip") / "mm.gguf", "nano", seed=3,
                                  hidden_act=request.param)
    return path, j_clip.load_mmproj(path), t_clip.load_mmproj(path, device="cpu")


@pytest.mark.parametrize("act", ACTS)
def test_write_mmproj_writes_the_jax_bytes(act, tmp_path):
    cfg, state, mm = testmodel.random_clip_weights("nano", 5, n_embd=48, hidden_act=act)
    j_write(tmp_path / "j.gguf", cfg=cfg, state=state, **mm)
    t_write(tmp_path / "t.gguf", cfg=cfg, state=state, **mm)
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()
    without_post = {k: v for k, v in state.items() if not k.startswith("post_layernorm")}
    j_write(tmp_path / "j2.gguf", cfg=cfg, state=without_post, **mm)
    t_write(tmp_path / "t2.gguf", cfg=cfg, state=without_post, **mm)
    assert (tmp_path / "t2.gguf").read_bytes() == (tmp_path / "j2.gguf").read_bytes()


def test_load_mmproj_matches_jax(mmproj):
    _, (jp, jcfg), (tp, tcfg) = mmproj
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.n_patches == 16 and tcfg.use_gelu == (jcfg.use_gelu)
    assert len(tp["layers"]) == len(jp["layers"]) == 3
    for k, v in jp.items():
        if k != "layers":
            assert tp[k].dtype == torch.float32 and tp[k].device.type == "cpu"
            np.testing.assert_array_equal(tp[k].numpy(), v)
    for tl, jl in zip(tp["layers"], jp["layers"]):
        assert set(tl) == set(jl)
        for k in jl:
            np.testing.assert_array_equal(tl[k].numpy(), jl[k])
    conv = clip_params_from_numpy(jp, "cpu")
    np.testing.assert_array_equal(conv["layers"][2]["ff_o_w"].numpy(), jp["layers"][2]["ff_o_w"])


IMAGES = {  # name -> (height, width) of a random uint8 HWC image
    "square_down": (64, 64), "square_up": (20, 20), "wide": (30, 50), "tall": (47, 13),
    "exact": (32, 32),
}


@pytest.mark.parametrize("name", list(IMAGES))
def test_preprocess_is_bitwise_the_jax_pixels(mmproj, name):
    """Padding to a square with (122, 116, 104), the bilinear resize and the
    normalization give the JAX package's f32 pixels bit for bit, from an
    array and from a PIL image (RGBA and gray too)."""
    from PIL import Image

    _, (_, jcfg), (_, tcfg) = mmproj
    h, w = IMAGES[name]
    img = np.random.default_rng(h * 100 + w).integers(0, 256, (h, w, 3), np.uint8)
    got = t_clip.preprocess_image(img, tcfg)
    assert got.dtype == np.float32 and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, j_clip.preprocess_image(img, jcfg))
    for mode in ("RGBA", "L"):
        pil = Image.fromarray(img).convert(mode)
        np.testing.assert_array_equal(t_clip.preprocess_image(pil, tcfg),
                                      j_clip.preprocess_image(pil, jcfg))
    if h != w:  # the padding shows as the background color past the image
        bg = (np.array([122, 116, 104]) / 255.0 - np.array(tcfg.image_mean)) / np.array(
            tcfg.image_std)
        np.testing.assert_allclose(got[-1, -1], bg, atol=1e-5)


def test_png_bytes_and_files_open_to_the_same_pixels(mmproj, tmp_path):
    """open_image reads a PNG from its bytes (the server's image_data) and
    from a file (the CLI's --image) to the pixels of the array it holds;
    bytes PIL cannot read raise OSError (the server's 400)."""
    from PIL import Image

    _, _, (_, tcfg) = mmproj
    img = np.random.default_rng(8).integers(0, 256, (24, 40, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    (tmp_path / "x.png").write_bytes(buf.getvalue())
    want = t_clip.preprocess_image(img, tcfg)
    for src in (buf.getvalue(), str(tmp_path / "x.png")):
        np.testing.assert_array_equal(t_clip.preprocess_image(t_clip.open_image(src), tcfg), want)
    with pytest.raises(OSError):
        t_clip.open_image(b"not an image")


@pytest.mark.parametrize("pixel_seed", [0, 1])
def test_encode_image_matches_jax(mmproj, pixel_seed):
    """The tower and projector on the same pixels: within ENCODE_RTOL of
    max|JAX|, on the port's own weights and on the JAX package's carried
    across; [n_patches, n_embd] f32 on the params' device."""
    _, (jp, jcfg), (tp, tcfg) = mmproj
    pixels = np.random.default_rng(pixel_seed).standard_normal((32, 32, 3)).astype(np.float32)
    want = j_clip.encode_image(jp, jcfg, pixels)
    for params in (tp, clip_params_from_numpy(jp, "cpu")):
        got = t_clip.encode_image(params, tcfg, pixels)
        assert got.shape == (16, 64) and got.dtype == torch.float32
        err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
        assert err <= ENCODE_RTOL, err
    got = t_clip.encode_image(tp, tcfg, torch.from_numpy(pixels))
    assert float(np.abs(got.numpy() - want).max() / np.abs(want).max()) <= ENCODE_RTOL


def test_encode_flops_counts_the_tower():
    """encode_flops at ViT-L/14-336 with a 4096-wide projector: about 0.35
    TFLOP (2 x 23 blocks' 302 M weights x 577 rows, attention, projector)."""
    cfg = t_clip.ClipConfig(image_size=336, patch_size=14, hidden=1024, n_heads=16, n_ff=4096,
                            n_layers=24, proj_dim=768, eps=1e-5, use_gelu=False,
                            image_mean=(0.5,) * 3, image_std=(0.5,) * 3)
    f = t_clip.encode_flops(cfg, 4096)
    assert cfg.n_patches == 576
    assert 3.5e11 < f < 4.0e11, f


def test_live_check_faults_move_the_embeddings(mmproj):
    """The image tower's chip check on the CPU at nano scale: one other
    f32 order stays 10x under live_check.CLIP_RTOL, each of CLIP_FAULTS
    lands 5x past it (over 2 blocks here; the card's tower runs 23)."""
    _, _, (tp, tcfg) = mmproj
    pixels = np.random.default_rng(2).standard_normal((32, 32, 3)).astype(np.float32)
    want = t_clip.encode_image(tp, tcfg, pixels)
    with LC.clip_other_order():
        order = LC.spread(t_clip.encode_image(tp, tcfg, pixels).numpy(), want.numpy())
    assert order < LC.CLIP_RTOL / 10
    for name in LC.CLIP_FAULTS:
        with LC.clip_fault(name):
            moved = LC.spread(t_clip.encode_image(tp, tcfg, pixels).numpy(), want.numpy())
        if name == "tanh GELU for quick GELU" and tcfg.use_gelu:
            assert moved == 0  # the blocks' activation is already tanh GELU
        else:
            assert moved > 5 * LC.CLIP_RTOL, (name, moved)
    assert LC.spread(t_clip.encode_image(tp, tcfg, pixels).numpy(), want.numpy()) == 0
