"""The port's ``import_torch`` (after_tpu_torch/cli/import_torch.py,
utils/port_torch.py, utils/gin_import.py) against the JAX package's.

No reference checkpoint is in the repository, so the reference state dicts
are synthetic: the JAX models' variables, every parameter and statistic
drawn from a seed, written under the reference's key names by the inverse
of the JAX package's mapping (``_reference_*`` below; the JAX import of
each state dict gives back exactly the drawn variables, which checks the
inverse).  A micro codec and a micro diffusion model, each with its
config.gin, go through both commands:

- the configs' JSON text is equal, and the gin readers agree;
- (a codec with GroupNorm: the port alone, held to the drawn weights);
- the port's imported codec loads the same tensors as the JAX import
  carried by ``utils.from_jax``, and its encode agrees with the JAX
  codec's within 1e-5 x max, its decode within 1e-4 x max (see below);
- the port's imported diffusion run holds the same tensors as the JAX
  import loaded into ``DiffusionTrainer.load_jax`` (the EMA at the
  denoiser), ``after-tpu-torch export``'s loader reads it with the codec
  run, and ``train --restart 0`` continues from it.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from after_tpu import config as jax_config
from after_tpu.cli import main as jax_cli
from after_tpu.diffusion.trainer import DiffusionTrainer as JaxTrainer
from after_tpu.models import AudioCodec as JaxCodec
from after_tpu.utils import gin_import as jax_gin
from after_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from after_tpu_torch import config as port_config
from after_tpu_torch.cli import main as cli
from after_tpu_torch.dataset import AudioExample, RecordWriter
from after_tpu_torch.diffusion.trainer import DiffusionTrainer
from after_tpu_torch.models.autoencoder import AudioCodec
from after_tpu_torch.utils import gin_import
from after_tpu_torch.utils.checkpoint import restore_checkpoint
from after_tpu_torch.utils.from_jax import load_module
from tests.torch_diffusion_common import random_variables

REL = 1e-5

CODEC_GIN = """
SR = 44100
LATENT_SIZE = 8
SimpleNetsStream.AutoEncoder:
    z_channels = %LATENT_SIZE
    channels = 8
    pqmf_bands = 4
    multipliers = [1, 2, 2]
    factors = [2, 2]
    dilations = [1, 3, 9]
    use_norm = False
    bottleneck = @SimpleNetsStream.ReluBottleneck()
"""

DIFFUSION_GIN = """
SR = 44100
IN_SIZE = 8
N_SIGNAL = 32
ZS_CHANNELS = 12
ZT_CHANNELS = 6
transformerv2.DenoiserV2:
    embed_dim = 64
    noise_embed_dims = 16
    n_layers = 2
    mlp_multiplier = 2
    dropout = 0.0
encoder/ecapa_encoder.ECAPATDNN.channels = [8, 8, 8, 16]
encoder/ecapa_encoder.ECAPATDNN.se_channels = 8
encoder/ecapa_encoder.ECAPATDNN.attention_channels = 8
encoder_time/encoder.Encoder1D.channels = [8, 8, 8, 8, 12]
classifier/encoder.Encoder1D.channels = [8, 8, 8, 8, 6]
"""


# ---------------------------------------------------------------------------
# the inverse of the JAX package's mapping (utils/port_torch.py)
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _wn(sd, prefix, p):
    sd[prefix + ".weight_v"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "g" in p:
        sd[prefix + ".weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _wn_transpose(sd, prefix, p):
    sd[prefix + ".weight_v"] = _t(
        np.asarray(p["kernel"])[::-1].transpose(1, 2, 0))
    sd[prefix + ".weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
    sd[prefix + ".bias"] = _t(p["bias"])


def _dense(sd, prefix, p, conv=False):
    w = np.asarray(p["kernel"]).T
    sd[prefix + ".weight"] = _t(w[:, :, None] if conv else w)
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _norm(sd, prefix, p, s=None):
    sd[prefix + ".weight"] = _t(p["scale"])
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])
    if s is not None:
        sd[prefix + ".running_mean"] = _t(s["mean"])
        sd[prefix + ".running_var"] = _t(s["var"])


def _snake(sd, prefix, p):
    sd[prefix + ".alpha"] = _t(np.asarray(p["alpha"]).reshape(1, -1, 1))
    sd[prefix + ".beta"] = _t(np.asarray(p["beta"]).reshape(1, -1, 1))


def _conv_block(sd, prefix, p):
    if "gn" in p:
        _norm(sd, prefix + ".net.0.gn", p["gn"]["gn"])
    _snake(sd, prefix + ".net.1", p["act"])
    _wn(sd, prefix + ".net.2", p["conv"])


def _res_block(sd, prefix, p):
    _conv_block(sd, prefix + ".net.branches.0.0", p["block1"])
    _conv_block(sd, prefix + ".net.branches.0.1", p["block2"])
    if "to_out" in p:
        _wn(sd, prefix + ".net.branches.1", p["to_out"])


def _reference_codec(params, n_stages, num_blocks):
    sd = {}
    enc, dec = params["encoder"], params["decoder"]
    _res_block(sd, "encoder.net.0", enc["to_in"])
    for i in range(n_stages):
        stage, d = f"encoder.net.{1 + i}.net", enc[f"down_{i}"]
        for j in range(num_blocks):
            _res_block(sd, f"{stage}.{j}", d[f"res_{j}"])
        _snake(sd, f"{stage}.{num_blocks}", d["act"])
        _wn(sd, f"{stage}.{num_blocks + 1}", d["down"])
    _snake(sd, f"encoder.net.{1 + n_stages}", enc["act"])
    _wn(sd, f"encoder.net.{2 + n_stages}", enc["to_out"])
    _wn(sd, "decoder.net.0", dec["to_in"])
    for i in range(n_stages):
        stage, u = f"decoder.net.{1 + i}.net", dec[f"up_{i}"]
        _snake(sd, f"{stage}.0", u["act"])
        _wn_transpose(sd, f"{stage}.1", u["up"])
        for j in range(num_blocks):
            _res_block(sd, f"{stage}.{2 + j}", u[f"res_{j}"])
    _conv_block(sd, "decoder.synth.branches.0.net.0", dec["to_out"]["block1"])
    _conv_block(sd, "decoder.synth.branches.0.net.1", dec["to_out"]["block2"])
    return sd


def _tdnn(sd, prefix, p, s):
    conv = p["conv"]["Conv_0"]
    sd[prefix + ".conv.conv.weight"] = _t(
        np.asarray(conv["kernel"]).transpose(2, 1, 0))
    sd[prefix + ".conv.conv.bias"] = _t(conv["bias"])
    _norm(sd, prefix + ".norm", p["bn"], s["bn"])


def _reference_diffusion(v, n_layers, n_ecapa, res2net):
    sd = {}
    net, tb = v["net"]["params"], "net.denoiser_trans_block."
    _dense(sd, "net.embedding.0", net["emb_dense1"])
    _dense(sd, "net.embedding.2", net["emb_dense2"])
    _dense(sd, tb + "patchify_and_embed.1", net["patchify"])
    if "tcond_patchify" in net:
        _dense(sd, tb + "patchify_and_embed_tcond.1", net["tcond_patchify"])
    if "pos_embed" in net:
        sd[tb + "pos_embed.weight"] = _t(net["pos_embed"])
    for i in range(n_layers):
        b, blk = tb + f"decoder_blocks.{i}.", net[f"block_{i}"]
        _dense(sd, b + "self_attention.qkv_linear", blk["attn"]["qkv"])
        _norm(sd, b + "norm1", blk["norm1"])
        _norm(sd, b + "norm3", blk["norm3"])
        _dense(sd, b + "mlp.mlp.0", blk["mlp"]["Dense_0"])
        _dense(sd, b + "mlp.mlp.2", blk["mlp"]["Dense_1"])
        if "cond_linear" in blk:
            _dense(sd, b + "linear", blk["cond_linear"])
        if "tcond_linear" in blk:
            _dense(sd, b + "tcond_linear", blk["tcond_linear"])
    _dense(sd, tb + "out_proj.0", net["out_proj"])

    p, s, e = v["encoder"]["params"], v["encoder"]["batch_stats"], "encoder."
    _tdnn(sd, e + "blocks.0", p["block_0"], s["block_0"])
    for i in range(1, n_ecapa - 1):
        b, bp, bs = e + f"blocks.{i}.", p[f"block_{i}"], s[f"block_{i}"]
        _tdnn(sd, b + "tdnn1", bp["tdnn1"], bs["tdnn1"])
        _tdnn(sd, b + "tdnn2", bp["tdnn2"], bs["tdnn2"])
        for j in range(res2net - 1):
            _tdnn(sd, b + f"res2net_block.blocks.{j}", bp["res2net"][
                f"tdnn_{j}"], bs["res2net"][f"tdnn_{j}"])
        _dense(sd, b + "se_block.conv1.conv", bp["se"]["conv1"], conv=True)
        _dense(sd, b + "se_block.conv2.conv", bp["se"]["conv2"], conv=True)
        if "shortcut" in bp:
            _dense(sd, b + "shortcut.conv", bp["shortcut"], conv=True)
    _tdnn(sd, e + "mfa", p["mfa"], s["mfa"])
    _tdnn(sd, e + "asp.tdnn", p["asp"]["tdnn"], s["asp"]["tdnn"])
    _dense(sd, e + "asp.conv.conv", p["asp"]["conv"], conv=True)
    _norm(sd, e + "asp_bn", p["asp_bn"], s["asp_bn"])
    _dense(sd, e + "fc.conv", p["fc"], conv=True)

    for name in ("encoder_time", "classifier"):
        p, s = v[name]["params"], v[name]["batch_stats"]
        n = len([k for k in p if k.startswith("block_")])
        for i in range(n + 1):
            blk = f"block_{i}" if i < n else "out_block"
            cp, cs = (p[blk]["conv"], s[blk]["conv"]) if i < n else (
                p[blk], s[blk])
            base = f"{name}.net.{i}" + (".net.0" if i < n else "")
            b = base + ".net.branches.0."
            _norm(sd, b + "0", cp["bn1"], cs["bn1"])
            _wn(sd, b + "2", cp["conv1"])
            _norm(sd, b + "3", cp["bn2"], cs["bn2"])
            _wn(sd, b + "6", cp["conv2"])
            if i < n:
                _wn(sd, f"{name}.net.{i}.net.1", p[blk]["pool"])
    return sd


# ---------------------------------------------------------------------------


def _same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in b:
            _same_tree(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    root = tmp_path_factory.mktemp("import_torch")
    out = {}
    # the codec
    run = root / "ref_codec"
    run.mkdir()
    (run / "config.gin").write_text(CODEC_GIN)
    jcfg = jax_gin.codec_config_from_gin(str(run / "config.gin"))
    shapes = jax.eval_shape(JaxCodec(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1024, 1)))
    codec_vars = random_variables(shapes, 1)
    torch.save(_reference_codec(codec_vars["params"], 2, 3),
               str(run / "checkpoint500000.pt"))
    # the diffusion model
    run = root / "ref_diffusion"
    run.mkdir()
    (run / "config.gin").write_text(DIFFUSION_GIN)
    dcfg = jax_gin.diffusion_config_from_gin(str(run / "config.gin"))
    shapes = jax.eval_shape(lambda k: JaxTrainer(dcfg).rf.init(k, 2),
                            jax.random.PRNGKey(0))
    diff_vars = random_variables(shapes, 2)
    torch.save({"model_state": _reference_diffusion(diff_vars, 2, 4, 8)},
               str(run / "checkpoint100000_EMA.pt"))
    for kind, ckpt in (("codec", root / "ref_codec" / "checkpoint500000.pt"),
                       ("diffusion",
                        root / "ref_diffusion" / "checkpoint100000_EMA.pt")):
        for pkg, main in (("jax", jax_cli.main), ("port", cli.main)):
            dest = str(root / f"{pkg}_{kind}")
            assert main(["import_torch", "--checkpoint", str(ckpt), "--type",
                         kind, "--out", dest]) == 0
            out[pkg, kind] = dest
    return root, out, jcfg, codec_vars, dcfg, diff_vars


def test_gin_readers_agree(imported):
    root = imported[0]
    for name, fn in (("ref_codec", "codec_config_from_gin"),
                     ("ref_diffusion", "diffusion_config_from_gin")):
        path = str(root / name / "config.gin")
        assert (gin_import.parse_gin(path) == jax_gin.parse_gin(path))
        ours, theirs = (getattr(gin_import, fn)(path),
                        getattr(jax_gin, fn)(path))
        to_json = (port_config.ae_to_json if name == "ref_codec"
                   else port_config.to_json)
        jax_to_json = (jax_config.ae_to_json if name == "ref_codec"
                       else jax_config.to_json)
        assert to_json(ours) == jax_to_json(theirs)


@pytest.mark.parametrize("kind", ["codec", "diffusion"])
def test_config_json_text_is_the_jax_commands(imported, kind):
    _, out, *_ = imported
    texts = []
    for pkg in ("port", "jax"):
        with open(os.path.join(out[pkg, kind], "config.json")) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]


def test_imported_codec_matches_jax(imported):
    _, out, jcfg, codec_vars, _, _ = imported
    theirs = jax_restore(out["jax", "codec"])["codec_vars"]
    _same_tree(theirs, codec_vars)            # the inverse mapping is exact
    cfg = port_config.load_codec_config(out["port", "codec"])
    codec = AudioCodec(cfg).eval()
    codec.load_state_dict(restore_checkpoint(out["port", "codec"])[
        "codec_vars"])
    via_jax = AudioCodec(cfg).eval()
    load_module(via_jax, jax.tree_util.tree_map(np.asarray, theirs), "codec")
    for k, v in via_jax.state_dict().items():
        torch.testing.assert_close(codec.state_dict()[k], v, rtol=0, atol=0)
    x = (0.3 * np.random.RandomState(0).randn(2, 4096, 1)).astype(np.float32)
    jcodec = JaxCodec(jcfg)
    jz = jcodec.apply(theirs, jnp.asarray(x), method=JaxCodec.encode)
    jy = jcodec.apply(theirs, jz, method=JaxCodec.decode)
    with torch.no_grad():
        z = codec.encode(torch.from_numpy(x))
        y = codec.decode(torch.from_numpy(np.array(jz)))
    # the decoder of these random, norm-free weights amplifies the two
    # frameworks' f32 rounding to 2.9e-5 x max: it is held to
    # tests/test_torch_codec.py's 1e-4
    for ours, ref, rel in ((z, jz, REL), (y, jy, 1e-4)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=rel * np.abs(ref).max())


def test_imported_diffusion_matches_jax_and_feeds_the_port(imported,
                                                            monkeypatch):
    root, out, _, _, dcfg, diff_vars = imported
    theirs = jax_restore(out["jax", "diffusion"])
    _same_tree(theirs["variables"], diff_vars)
    cfg = port_config.from_json(jax_config.to_json(dcfg))
    via_jax = DiffusionTrainer(cfg, device="cpu").load_jax(
        jax.tree_util.tree_map(np.asarray, theirs["variables"]),
        jax.tree_util.tree_map(np.asarray, theirs["ema_params"]))
    tree = restore_checkpoint(out["port", "diffusion"])
    expected = via_jax.state_tree()
    assert tree["step"] == 0
    for name, sd in expected["variables"].items():
        for k, v in sd.items():
            torch.testing.assert_close(tree["variables"][name][k], v,
                                       rtol=0, atol=0)
    for k, v in expected["ema_params"].items():
        torch.testing.assert_close(tree["ema_params"][k], v, rtol=0, atol=0)
    # export's loader reads the run with the codec run
    from after_tpu_torch.cli.export import load_run
    _, pipe = load_run(out["port", "diffusion"], out["port", "codec"],
                       device="cpu")
    for k, v in via_jax.rf.net.state_dict().items():
        torch.testing.assert_close(pipe.rf.net.state_dict()[k], v, rtol=0,
                                   atol=0)
    # train continues from it
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rng = np.random.RandomState(0)
    with RecordWriter(str(root / "zdb")) as w:
        for i in range(4):
            ae = AudioExample()
            ae.put_array("z", rng.randn(8, 64).astype(np.float32))
            w.put(f"{i:08d}", ae.serialize())
    runs = root / "runs"
    os.makedirs(runs)
    os.symlink(out["port", "diffusion"], runs / "imported")
    assert cli.main(["train", "--name", "imported", "--db_path",
                     str(root / "zdb"), "--out_path", str(runs),
                     "--batch_size", "2", "--max_steps", "1", "--restart",
                     "0", "--device", "cpu", "--override",
                     "train.steps_valid=100"]) == 0
    assert restore_checkpoint(out["port", "diffusion"], 1)["step"] == 1


def test_codec_with_group_norm(tmp_path):
    """A codec with GroupNorm (the JAX package's import maps its GroupNorm
    one level too high, so the port is held to the drawn weights)."""
    (tmp_path / "config.gin").write_text(
        CODEC_GIN.replace("use_norm = False", "use_norm = True"))
    jcfg = jax_gin.codec_config_from_gin(str(tmp_path / "config.gin"))
    assert jcfg.use_norm
    shapes = jax.eval_shape(JaxCodec(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1024, 1)))
    codec_vars = random_variables(shapes, 3)
    pt = tmp_path / "checkpoint.pt"
    torch.save(_reference_codec(codec_vars["params"], 2, 3), str(pt))
    assert cli.main(["import_torch", "--checkpoint", str(pt), "--type",
                     "codec", "--out", str(tmp_path / "out")]) == 0
    cfg = port_config.load_codec_config(str(tmp_path / "out"))
    expected = AudioCodec(cfg)
    load_module(expected, codec_vars, "codec")
    got = restore_checkpoint(str(tmp_path / "out"))["codec_vars"]
    assert any(k.endswith("gn.gn.weight") for k in got)
    for k, v in expected.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_a_checkpoint_without_config_gin_is_refused(tmp_path):
    """Without a config.gin the default config and the geometry flags
    build the modules (tests/test_torch_import_torch_nogin.py); a state
    dict that does not fit them is refused, naming the config.gin."""
    pt = tmp_path / "checkpoint.pt"
    torch.save({}, str(pt))
    with pytest.raises(SystemExit, match="config.gin"):
        cli.main(["import_torch", "--checkpoint", str(pt), "--type", "codec",
                  "--out", str(tmp_path / "out")])
