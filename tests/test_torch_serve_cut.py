"""PyTorch port: the serve CLI serves an image cut in depth (widths kept).

An image holding the first layer of a smoke model's params is served inline
and through a local proxy: the CLI takes the depth from the image's stacked
block leaves, and both give the tokens that ``decode_arch`` with
``num_layers=1`` steps to from the same params.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ChunkStore
from repro_torch.core import ForkedCheckpointer
from repro_torch.launch import serve
from repro_torch.proxy import make_program

P, G = 12, 6
SPEC = {"name": "decode_arch", "arch": "qwen2-0.5b", "smoke": True, "batch": 2,
        "prompt_len": P, "gen": G, "device": "cpu", "num_layers": 1}


@pytest.fixture(scope="module")
def cut_image(tmp_path_factory):
    prog = make_program(SPEC)
    params = prog.model.init(torch.Generator().manual_seed(3))
    assert params["blocks"]["ln1"].shape[0] == 1
    store = str(tmp_path_factory.mktemp("cut") / "ckpt")
    ckpt = ForkedCheckpointer(ChunkStore(store), codec="none", backend="thread")
    ckpt.save_sync(6, {"device": {"params": params}})
    ckpt.close()
    state = prog.init_state(params)
    for n in range(1, P + G):
        state, _ = prog.step(state, n)
    return store, state["toks"][:, P:].numpy()


@pytest.mark.parametrize("runner", [[], ["--device-runner", "proxy"]], ids=["inline", "proxy"])
def test_cut_serves_the_programs_tokens(cut_image, runner):
    store, want = cut_image
    out = serve.serve(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                       "--ckpt-dir", store, "--lazy",
                       "--batch", "2", "--prompt-len", str(P), "--gen", str(G)] + runner)
    np.testing.assert_array_equal(np.asarray(out["tokens"]), want)


def test_image_layers_reads_the_images_depth(cut_image, tmp_path):
    assert serve._image_layers(cut_image[0]) == 1
    assert serve._image_layers(str(tmp_path)) is None
    assert serve._image_layers(None) is None

