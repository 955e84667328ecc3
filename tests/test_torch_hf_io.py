"""models/hf_io.py on the CPU against the JAX package and the safetensors
package: a checkpoint the port writes loads in JAX's hf_io and in
safetensors with equal tensors, one JAX writes loads in the port, ragged
ranks round-trip, and the port's own reader takes BF16, sharded
checkpoints and .bin files."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import save_file as torch_save_file

from palu_tpu.compression import compress_params as jcompress
from palu_tpu.models import hf_io as jhf
from palu_tpu.models import llama as jl
from palu_tpu.models.config import ModelConfig as JModelConfig
from palu_tpu_torch.convert import config_from_dict, params_from_numpy
from palu_tpu_torch.models import hf_io as thf
from palu_tpu_torch.models import llama as tl


def _cfg():
    return JModelConfig(vocab_size=64, hidden_size=64, intermediate_size=96,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                        max_position_embeddings=64)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, np.asarray(tree.float() if isinstance(tree, torch.Tensor) else tree,
                               np.float32)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.fixture(scope="module")
def compressed():
    """JAX params compressed with uniform (layer 0) and ragged (layer 1)
    ranks, and the same tree in the port."""
    cfg = _cfg()
    params = jl.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    sel = {"model.layers.0.self_attn.k_proj": [16, 16], "model.layers.0.self_attn.v_proj": [8, 8],
           "model.layers.1.self_attn.k_proj": [8, 16], "model.layers.1.self_attn.v_proj": [16, 8]}
    jp, jcfg = jcompress(params, cfg, sel, decompose_method="svd", head_group_size=2)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, jcfg, tp, config_from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_port_checkpoint_loads_in_jax_and_safetensors(tmp_path, compressed, dtype):
    jp, jcfg, tp, tcfg = compressed
    d = str(tmp_path / "port")
    thf.save_checkpoint(tp, tcfg, d, "org/base", dtype=dtype)
    # the safetensors package reads the port's file: every tensor, as JAX writes it
    jd = str(tmp_path / "jax")
    jhf.save_checkpoint(jp, jcfg, jd, "org/base", dtype=np.dtype(str(dtype).split(".")[1]))
    got, want = np_load_file(f"{d}/model.safetensors"), np_load_file(f"{jd}/model.safetensors")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(f"{d}/config.json") as f, open(f"{jd}/config.json") as g:
        assert json.load(f) == json.load(g)
    # and JAX's loader reads it back to the same tree
    loaded, lcfg = jhf.load_params(d, dtype=jnp.float32)
    ref, _ = jhf.load_params(jd, dtype=jnp.float32)
    _assert_trees_equal(jax.tree.map(np.asarray, loaded), jax.tree.map(np.asarray, ref))
    assert lcfg == jcfg
    assert jl.is_ragged(loaded["layers"][1]["attn"]["k_proj"])


def test_jax_checkpoint_loads_in_port(tmp_path, compressed):
    jp, jcfg, _, _ = compressed
    d = str(tmp_path / "jax")
    jhf.save_checkpoint(jp, jcfg, d, "org/base", dtype=np.float32)
    want, wcfg = jhf.load_params(d, dtype=jnp.float32)
    got, gcfg = thf.load_params(d, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(gcfg) == dataclasses.asdict(wcfg)
    assert isinstance(got["layers"][1]["attn"]["k_proj"]["U"], tuple)
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))


def test_ragged_round_trip_keeps_logits(tmp_path, compressed):
    _, _, tp, tcfg = compressed
    d = str(tmp_path / "ragged")
    thf.save_checkpoint(tp, tcfg, d, dtype=torch.float32)
    loaded, lcfg = thf.load_params(d, dtype=torch.float32, device="cpu")
    assert tl.is_ragged(loaded["layers"][1]["attn"]["v_proj"])
    assert "w_fused" in loaded["layers"][0]["attn"]["o_proj"]
    assert "w_fused" not in loaded["layers"][1]["attn"]["o_proj"]
    ids = torch.arange(10)[None, :] % tcfg.vocab_size
    np.testing.assert_array_equal(tl.forward(loaded, ids, lcfg).numpy(),
                                  tl.forward(tp, ids, tcfg).numpy())


def _dense_state_dict(cfg, gen, dtype):
    """An HF-named dense state dict (out, in) for cfg."""
    h, inter, kv = cfg.hidden_size, cfg.intermediate_size, cfg.num_key_value_heads * cfg.head_dim

    def r(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    sd = {"model.embed_tokens.weight": r(cfg.vocab_size, h), "model.norm.weight": r(h),
          "lm_head.weight": r(cfg.vocab_size, h)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        shapes = {"input_layernorm": (h,), "post_attention_layernorm": (h,),
                  "self_attn.q_proj": (h, h), "self_attn.k_proj": (kv, h),
                  "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, h),
                  "mlp.gate_proj": (inter, h), "mlp.up_proj": (inter, h),
                  "mlp.down_proj": (h, inter)}
        sd.update({f"{p}.{name}.weight": r(*shape) for name, shape in shapes.items()})
    return sd


def _write_config(d, cfg):
    raw = {k: getattr(cfg, k) for k in ("vocab_size", "hidden_size", "intermediate_size",
                                         "num_hidden_layers", "num_attention_heads",
                                         "num_key_value_heads")}
    with open(d / "config.json", "w") as f:
        json.dump({**raw, "model_type": "llama"}, f)


@pytest.mark.parametrize("layout", ["single", "sharded", "bin"])
def test_reads_bf16_sharded_and_bin(tmp_path, layout):
    cfg = _cfg()
    sd = _dense_state_dict(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    _write_config(tmp_path, cfg)
    if layout == "single":
        torch_save_file(sd, str(tmp_path / "model.safetensors"))
    elif layout == "sharded":
        names = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": names[::2],
                  "model-00002-of-00002.safetensors": names[1::2]}
        for fname, keys in shards.items():
            torch_save_file({k: sd[k] for k in keys}, str(tmp_path / fname))
        with open(tmp_path / "model.safetensors.index.json", "w") as f:
            json.dump({"weight_map": {k: fn for fn, ks in shards.items() for k in ks}}, f)
    else:
        torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    got = thf._read_state_dict(str(tmp_path))
    assert sorted(got) == sorted(sd)
    for k in sd:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], sd[k]), k
    params, lcfg = thf.load_params(str(tmp_path), dtype=torch.float32, device="cpu")
    assert lcfg.head_wise_ranks is None and "w" in params["layers"][0]["attn"]["k_proj"]
    np.testing.assert_array_equal(params["layers"][1]["attn"]["q_proj"]["w"].numpy(),
                                  sd["model.layers.1.self_attn.q_proj.weight"].float().T.numpy())


def test_writer_round_trips_every_dtype(tmp_path):
    gen = torch.Generator().manual_seed(1)
    ts = {"f32": torch.randn((3, 5), generator=gen), "bf16": torch.randn((7,)).bfloat16(),
          "f16": torch.randn((2, 2, 2)).half(), "i8": torch.randint(-9, 9, (4,)).to(torch.int8),
          "u8": torch.randint(0, 255, (6,)).to(torch.uint8), "empty": torch.zeros((0, 3)),
          "t": torch.randn((4, 6)).T}
    path = str(tmp_path / "x.safetensors")
    thf.write_safetensors(ts, path, metadata={"format": "pt"})
    got = thf.read_safetensors(path)
    for k, v in ts.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert (8 + n) % 8 == 0
    from safetensors.torch import load_file

    for k, v in load_file(path).items():
        assert torch.equal(v, ts[k]), k


def test_load_config_rejects_unknown_model_type(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "gptneox", "vocab_size": 1, "hidden_size": 1, "intermediate_size": 1,
        "num_hidden_layers": 1, "num_attention_heads": 1}))
    with pytest.raises(ValueError):
        thf.load_config(str(tmp_path))
