"""The dry-run of every assigned arch at train_4k, prefill_32k and
decode_32k on the (16, 16) production mesh against the JAX package's
rules: argument and output bytes a device equal JAX's step's (through
``jax.eval_shape`` of its steps and its sharding rules, no compile), the
peak estimate is JAX's formula over the port's step
(``launch.memory``) and at least the arguments, and the counted FLOPs
are those of the kernels' plain versions, run live at one case of each
kernel.  Each case runs its full-size step on the meta device once (a
few seconds to half a minute), once a process: ``_case`` is
``test_torch_dryrun``'s cache, whose own cases share it."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.models import model as JM
from repro.train import sharding_rules as JR
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from test_torch_dryrun import _case


def _jax_mesh():
    m = make_production_mesh()
    return SimpleNamespace(shape=m.shape, axis_names=m.axis_names)


def _jax_bytes(mesh, tree, specs) -> int:
    """Bytes a device holds of a ShapeDtypeStruct tree laid out by JAX's
    specs."""
    leaves = jax.tree_util.tree_leaves(tree)
    flat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for x, spec in zip(leaves, flat):
        n = np.dtype(x.dtype).itemsize
        dims = list(x.shape)
        for i, e in enumerate(tuple(spec)):
            for a in (() if e is None else (e,) if isinstance(e, str) else e):
                dims[i] //= mesh.shape[a]
        total += n * int(np.prod(dims))
    return total


# counted_flops of every assigned arch at three shapes on 16 x 16, as the
# dry-run counted them through the kernels' plain versions before the meta
# route: a cheap pin of every case.  A change that alters a plain
# version's products fails here; test_plain_route_counts_what_the_meta_
# route_counts, which runs the plain versions live, then says whether the
# meta formulas or the plain versions moved
FLOPS_BEFORE = {
    'granite-moe-3b-a800m/train_4k': 9056952155897856,
    'zamba2-2.7b/train_4k': 21640656577363968,
    'whisper-large-v3/train_4k': 11707771477032960,
    'llama4-scout-17b-a16e/train_4k': 123719797136424960,
    'llama-3.2-vision-90b/train_4k': 579275502070530048,
    'codeqwen1.5-7b/train_4k': 55943151621242880,
    'mamba2-370m/train_4k': 2561312336904192,
    'yi-9b/train_4k': 64070741573763072,
    'mistral-large-123b/train_4k': 824580944273866752,
    'stablelm-12b/train_4k': 83716815338864640,
    'granite-moe-3b-a800m/decode_32k': 1669903417344,
    'zamba2-2.7b/decode_32k': 866857779200,
    'whisper-large-v3/decode_32k': 977692262400,
    'llama4-scout-17b-a16e/decode_32k': 31448220303360,
    'llama-3.2-vision-90b/decode_32k': 33170032427008,
    'codeqwen1.5-7b/decode_32k': 4200478015488,
    'mamba2-370m/decode_32k': 97576288256,
    'yi-9b/decode_32k': 5493263171584,
    'mistral-large-123b/decode_32k': 49426483642368,
    'stablelm-12b/decode_32k': 6412923043840,
    'granite-moe-3b-a800m/prefill_32k': 8929958562889728,
    'zamba2-2.7b/prefill_32k': 9984321494450176,
    'whisper-large-v3/prefill_32k': 8111648459980800,
    'llama4-scout-17b-a16e/prefill_32k': 70794804933427200,
    'llama-3.2-vision-90b/prefill_32k': 271750895874605056,
    'codeqwen1.5-7b/prefill_32k': 34410315902877696,
    'mamba2-370m/prefill_32k': 853770778968064,
    'yi-9b/prefill_32k': 45000811901616128,
    'mistral-large-123b/prefill_32k': 404901753998278656,
    'stablelm-12b/prefill_32k': 52534665575137280,
}
ZOO = [tuple(k.split("/")) for k in FLOPS_BEFORE]


def _jax_io(arch: str, shape_name: str):
    """(argument, output) bytes a device of JAX's step for one case on 16
    x 16: its arguments as JAX's ``input_specs`` gives them and its
    outputs through ``jax.eval_shape``, each laid out by JAX's sharding
    rules (params and AdamW moments by ``param_specs``, the decode state
    by ``decode_state_specs``, a batch dimension by
    ``array_batch_specs``, scalars whole)."""
    from repro.train import make_serve_step, make_train_step
    from repro.train import trainer as JT
    from repro.train.optimizer import init_adamw as j_init_adamw

    mesh = _jax_mesh()
    shape = jget_shape(shape_name)
    cfg = D.arch_for_shape(jget_config(arch), shape)
    pv = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), cfg,
                                              jnp.bfloat16))
    ps = JR.param_specs(mesh, cfg, pv)
    P = jax.sharding.PartitionSpec

    def rows(tree):
        return _jax_bytes(mesh, tree, JR.array_batch_specs(mesh, tree))

    def scalars(tree):
        return _jax_bytes(mesh, tree, jax.tree_util.tree_map(
            lambda _: P(), tree))

    B, S = shape.global_batch, shape.seq_len
    sds = jax.ShapeDtypeStruct
    if shape.phase == "decode":
        st = jax.eval_shape(lambda: JM.init_decode_state(cfg, B, S,
                                                         jnp.bfloat16))
        token, pos = sds((B, 1), jnp.int32), sds((), jnp.int32)
        logits, st2 = jax.eval_shape(make_serve_step(cfg), pv, token, st,
                                     pos)
        args = (_jax_bytes(mesh, pv, ps) + rows(token) + scalars(pos)
                + _jax_bytes(mesh, st, JR.decode_state_specs(mesh, cfg, st)))
        outs = rows(logits) + _jax_bytes(
            mesh, st2, JR.decode_state_specs(mesh, cfg, st2))
        return args, outs
    batch = {"tokens": sds((B, S), jnp.int32)}
    for k in ("old_logprobs", "advantages", "loss_mask"):
        batch[k] = sds((B, S), jnp.float32)
    if cfg.kind == "vlm":
        batch["image_embeds"] = sds((B, cfg.num_image_tokens, cfg.d_model),
                                    jnp.bfloat16)
    if cfg.kind == "encdec":
        batch["frame_embeds"] = sds((B, cfg.encoder_seq_len, cfg.d_model),
                                    jnp.bfloat16)
    if shape.phase == "prefill":
        lp = jax.eval_shape(JT.make_prefill_step(cfg), pv, batch)
        return _jax_bytes(mesh, pv, ps) + rows(batch), rows(lp)
    opt = jax.eval_shape(j_init_adamw, pv)
    p2, o2, metrics = jax.eval_shape(
        make_train_step(cfg, JT.TrainHParams(remat=True)), pv, opt, batch)

    def state(params, o):
        return (_jax_bytes(mesh, params, ps) + _jax_bytes(mesh, o.mu, ps)
                + _jax_bytes(mesh, o.nu, ps) + scalars(o.step))

    return state(pv, opt) + rows(batch), state(p2, o2) + scalars(metrics)


# AdamW's step count (int32) is a host number in the port, and so is the
# learning rate of the step's metrics (f32): JAX holds both on the device
HOST_SCALARS = {"train_4k": (4, 8), "prefill_32k": (0, 0),
                "decode_32k": (0, 0)}


@pytest.mark.parametrize("arch,shape", ZOO, ids=[f"{a}-{s}" for a, s in ZOO])
def test_argument_and_output_bytes_equal_jax(arch, shape):
    """JAX's memory keys: the port's argument and output bytes a device
    equal JAX's step's through its rules, but for AdamW's step and the
    learning rate, which the port keeps on the host (``HOST_SCALARS``)."""
    m = _case(arch, shape, False)["memory"]
    args, outs = _jax_io(arch, shape)
    host_args, host_outs = HOST_SCALARS[shape]
    assert (m["argument_bytes"], m["output_bytes"]) == \
        (args - host_args, outs - host_outs)


@pytest.mark.parametrize("arch,shape", ZOO, ids=[f"{a}-{s}" for a, s in ZOO])
def test_peak_estimate_and_flops_of_every_case(arch, shape):
    """The peak estimate is JAX's formula over the step's own figures, at
    least the arguments; ``fits`` reads it; the counted FLOPs are the
    plain route's."""
    r = _case(arch, shape, False)
    m = r["memory"]
    assert set(m) >= {"argument_bytes", "output_bytes", "temp_bytes",
                      "alias_bytes", "peak_est_bytes", "fits",
                      "resident_bytes", "fits_resident"}
    assert "excludes" not in m
    assert m["peak_est_bytes"] == m["argument_bytes"] + m["temp_bytes"] \
        + m["output_bytes"] - m["alias_bytes"]
    assert m["peak_est_bytes"] >= m["argument_bytes"] > 0
    assert m["fits"] == (m["peak_est_bytes"] <= m["hbm_bytes"])
    assert r["flops"]["counted_flops"] == FLOPS_BEFORE[f"{arch}/{shape}"]
    if shape == "train_4k":  # AdamW in place: the params and moments
        assert m["alias_bytes"] == m["param_bytes"] + m["opt_bytes"]
        assert m["argument_bytes"] == m["resident_bytes"]


def _plain_route():
    """``kernels.ops``'s meta route sent to the kernels' plain versions,
    as the CPU route calls them."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gmm as GMM
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import ssm_update as SSU

    def flash(q, k, v, causal, window):
        return FA.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)[0]

    def ssd(x, dt, A, Bm, Cm, Dh, save):
        return SSD.ssd_scan_plain(x, dt, A, Bm, Cm, Dh)

    return SimpleNamespace(
        FlashAttention=SimpleNamespace(apply=flash),
        SSDScan=SimpleNamespace(apply=ssd),
        moe_decode=GMM.moe_decode_gmm_plain,
        ssm_state_update=SSU.ssm_state_update_plain)


# one case of each kernel op the dry-run reaches: K3 causal at train and
# prefill, K3 bidirectional (whisper's encoder), K6 with K3 (zamba2's
# train), K5 and K7 at decode
PLAIN_CASES = [("yi-9b", "train_4k"), ("yi-9b", "prefill_32k"),
               ("whisper-large-v3", "train_4k"), ("zamba2-2.7b", "train_4k"),
               ("granite-moe-3b-a800m", "decode_32k"),
               ("mamba2-370m", "decode_32k")]


@pytest.mark.parametrize("arch,shape", PLAIN_CASES,
                         ids=[f"{a}-{s}" for a, s in PLAIN_CASES])
def test_plain_route_counts_what_the_meta_route_counts(arch, shape,
                                                       monkeypatch):
    """At full size, ``counted`` with every kernel op on its plain
    version (under ``FlopCounterMode``, run now) counts the FLOPs that
    the dry-run counts through the meta kernel ops' formulas."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels import ops as KOPS
    from repro_torch.models import model as M

    sh = get_shape(shape)
    cfg = D.arch_for_shape(get_config(arch), sh)
    params = D.meta_params(cfg)
    batch = state = None
    if sh.phase == "decode":
        state = M.init_decode_state(cfg, sh.global_batch, sh.seq_len,
                                    D.PARAM_DTYPE, D.META)
    else:
        batch = D.meta_batch(cfg, sh)
    monkeypatch.setattr(KOPS, "_kmeta", _plain_route())
    plain, _ = D.counted(cfg, sh, params, batch, state)
    assert plain == _case(arch, shape, False)["flops"]["counted_flops"] > 0
