"""Rules of the PyTorch/CUDA port, checked on the CPU:

- no module of ``apex_tpu_torch`` (nor ``chip_smoke.py``) imports
  ``jax``, ``jaxlib`` or the JAX package ``apex_tpu``;
- entry points run on the card by default: ``device=None`` on a host
  without CUDA raises, naming ``device='cpu'``;
- a CUDA tensor goes to the kernel or raises: with dispatch sent to the
  card, no path reaches a plain version, and no wrapper falls back;
- a kernel's launch count moves only on a successful launch;
- ``chip_smoke.py`` fails, printing no result, without a card and when
  run outside the repository;
- each ported optimizer's constructor has the reference's signature:
  names, order, kinds and defaults (dtypes by name: ``jnp.float32`` is
  ``torch.float32``);
- every ported module's public functions, classes and methods have the
  reference module's names and parameters, and its dataclasses and named
  tuples the reference's fields, names and defaults (an AST scan of the
  reference against the port's signatures and fields), except the deliberate
  departures, listed by name, and the names owed to later queue-A items
  of ``ROADMAP.md``, listed by item; modules with no reference are
  listed as port-only."""

import ast
import dataclasses
import enum
import importlib
import inspect
import os
import shutil
import subprocess
import sys

import pytest
import torch

from apex_tpu_torch import amp as port_amp
from apex_tpu_torch.examples.bert.train import make_bert_train_step
from apex_tpu_torch.examples.gpt import pretrain_gpt
from apex_tpu_torch.examples.gpt import train as gpt_train
from apex_tpu_torch.examples.imagenet.main_amp import make_resnet_train_step
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.models import init_resnet
from apex_tpu_torch import optimizers as port_optimizers
from apex_tpu_torch import serving as port_serving
from apex_tpu_torch.utils import cuda_build
from apex_tpu_torch.utils.platform import resolve_device

# the packages re-export each function under its module's name
ln = importlib.import_module("apex_tpu_torch.normalization.fused_layer_norm")
fa = importlib.import_module(
    "apex_tpu_torch.transformer.functional.flash_attention")
xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")
fsm = importlib.import_module(
    "apex_tpu_torch.transformer.functional.fused_softmax")
mta = importlib.import_module("apex_tpu_torch.multi_tensor_apply.kernels")
w8 = importlib.import_module("apex_tpu_torch.quant.kernels")
prng = importlib.import_module("apex_tpu_torch.utils.prng")
rope = importlib.import_module(
    "apex_tpu_torch.transformer.functional.fused_rope")

# the plain forwards, saved before any test patches them
_plain = {"ln": ln.layer_norm_fwd_plain, "fa": fa.attention_fwd_plain,
          "xent": xent.xentropy_fwd_plain,
          "softmax": fsm.masked_softmax_fwd_plain,
          "causal": fsm.causal_softmax_fwd_plain}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "apex_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "apex_tpu"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames.sort()
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return out


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 20
    bad = {os.path.relpath(p, REPO): sorted(set(_imported_roots(p))
                                            & FORBIDDEN)
           for p in files}
    assert {p: r for p, r in bad.items() if r} == {}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    "resolve_device", "init_gpt", "init_cache", "DecodeEngine",
    "params_from_jax", "init_bert", "make_bert_train_step",
    "scaler_init_state", "init_resnet", "resnet_step_init_state",
    "init_gpt_from_key", "rope_frequencies", "rope_cos_sin",
    "gpt_make_state", "gpt_train_main", "pretrain_gpt_main"])
def test_default_device_is_the_card(no_cuda, entry):
    cfg = port_gpt.gpt_tiny()
    bcfg = port_bert.bert_tiny()
    calls = {
        "resolve_device": lambda: resolve_device(None),
        "init_gpt": lambda: port_gpt.init_gpt(cfg, torch.Generator()),
        "init_cache": lambda: port_serving.init_cache(cfg, 1, 8),
        "DecodeEngine": lambda: port_serving.DecodeEngine({}, cfg, 1, 8),
        "params_from_jax": lambda: port_gpt.params_from_jax({}, None),
        "init_bert": lambda: port_bert.init_bert(bcfg, torch.Generator()),
        "make_bert_train_step": lambda: make_bert_train_step(2, 8, bcfg),
        "scaler_init_state": lambda: port_amp.initialize(
            "O2", verbosity=0).init_state(),
        "init_resnet": lambda: init_resnet(torch.Generator(), 10, 10),
        "resnet_step_init_state": lambda: make_resnet_train_step(
            10).init_state({"w": torch.zeros(2)}, {}),
        "init_gpt_from_key": lambda: port_gpt.init_gpt_from_key(
            prng.PRNGKey(0), cfg),
        "rope_frequencies": lambda: rope.rope_frequencies(8, 4),
        "rope_cos_sin": lambda: rope.rope_cos_sin(8, 4),
        "gpt_make_state": lambda: gpt_train.make_state(
            cfg, port_optimizers.FusedAdam()),
        "gpt_train_main": lambda: gpt_train.main(["--config", "tiny"]),
        "pretrain_gpt_main": lambda: pretrain_gpt.main([]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    assert resolve_device("cpu").type == "cpu"


@pytest.fixture
def dispatch_to_card(monkeypatch):
    """Send every wrapper's dispatch to the kernel branch and make the
    plain versions fail loudly if anything reaches them."""
    def plain(*a, **k):
        raise AssertionError("plain version reached on the CUDA path")

    for mod in (ln, fa, xent, fsm, mta, w8, prng):
        monkeypatch.setattr(mod, "on_card", lambda t, what="": True)
    for mod, name in ((ln, "layer_norm_fwd_plain"),
                      (ln, "layer_norm_bwd_plain"),
                      (fa, "attention_fwd_plain"),
                      (fa, "attention_bwd_plain"),
                      (xent, "xentropy_fwd_plain"),
                      (xent, "xentropy_bwd_plain"),
                      (fsm, "masked_softmax_fwd_plain"),
                      (fsm, "causal_softmax_fwd_plain"),
                      (fsm, "softmax_bwd_plain"),
                      (mta, "flat_adam_plain"),
                      (mta, "flat_scale_plain"),
                      (mta, "flat_axpby_plain"),
                      (mta, "flat_l2norm_partials_plain"),
                      (mta, "flat_lamb_stage1_plain"),
                      (mta, "flat_sgd_plain"),
                      (mta, "flat_adagrad_plain"),
                      (mta, "flat_novograd_plain"),
                      (w8, "w8_matmul_plain"),
                      (w8, "w8_matmul_nk_plain"),
                      (prng, "threefry_bits_plain"),
                      (prng, "dropout_plain")):
        monkeypatch.setattr(mod, name, plain)


def test_cuda_path_never_reaches_plain_layer_norm(dispatch_to_card):
    x = torch.randn(4, 16)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ln.fused_layer_norm_affine(x, torch.ones(16), torch.zeros(16), 16)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ln.fused_rms_norm(x, 16)


def test_cuda_path_never_reaches_plain_attention(dispatch_to_card):
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        fa.flash_attention(q, q, q, causal=True)


def test_cuda_path_never_reaches_plain_threefry(monkeypatch,
                                                dispatch_to_card):
    """The dropout goes to its kernel wrapper, which refuses a CPU
    tensor; bits on a CUDA device go to the kernel wrapper, never to the
    plain version."""
    x = torch.randn(4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        prng.dropout(prng.PRNGKey(0), x, 0.1)
    calls = []
    monkeypatch.setattr(prng, "threefry_bits_kernel",
                        lambda *a: calls.append(a[2]))
    prng._bits_rows(prng.PRNGKey(0), 4, torch.device("cuda"))
    assert calls == [torch.device("cuda")]
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        prng.threefry_bits_kernel(prng.PRNGKey(0), 4, "cpu")


def test_step_without_dropout_rng_draws_nothing(monkeypatch):
    """A training step without ``dropout_rng`` (the JAX benchmark's step)
    and a greedy serving tick reach no threefry draw."""
    def fail(*a, **k):
        raise AssertionError("threefry drawn")

    monkeypatch.setattr(prng, "_bits_rows", fail)
    monkeypatch.setattr(prng, "_dropout_any", fail)
    step, make_state, (ids, mask) = make_bert_train_step(
        2, 8, port_bert.bert_tiny(), device="cpu")
    step(*make_state(), ids, mask)
    cfg = port_gpt.gpt_tiny()
    eng = port_serving.DecodeEngine(
        port_gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                          device="cpu"), cfg, num_slots=2, max_len=16,
        device="cpu")
    sched = port_serving.ContinuousBatchingScheduler(eng, eos_id=-1)
    sched.submit(port_serving.Request(prompt=(3, 4), max_new_tokens=3))
    with torch.inference_mode():
        assert len(sched.run()[0]) == 3


def test_cuda_path_never_reaches_plain_xentropy(dispatch_to_card):
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        xent.softmax_cross_entropy_loss(torch.randn(4, 10),
                                        torch.zeros(4, dtype=torch.long))


def test_cuda_path_never_reaches_plain_softmax(dispatch_to_card):
    x = torch.randn(1, 2, 4, 8)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        fsm.scaled_masked_softmax(x, torch.zeros((1, 1, 1, 8),
                                                 dtype=torch.int32))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        fsm.scaled_upper_triang_masked_softmax(x)


def test_cuda_path_never_reaches_plain_flat_adam(dispatch_to_card):
    from apex_tpu_torch.optimizers import FusedAdam

    params = {"w": torch.randn(4, 8), "b": torch.randn(8)}
    opt = FusedAdam(use_flat_kernel=True)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        opt.step(params, params, opt.init(params))


def test_cuda_path_never_reaches_plain_flat_lamb(dispatch_to_card):
    from apex_tpu_torch.optimizers import FusedLAMB

    params = {"w": torch.randn(4, 8), "b": torch.randn(8)}
    opt = FusedLAMB(use_flat_kernel=True)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        opt.step(params, params, opt.init(params))


@pytest.mark.parametrize("opt", ["FusedSGD", "FusedAdagrad",
                                 "FusedNovoGrad"])
def test_cuda_path_never_reaches_plain_flat_sgd_family(dispatch_to_card,
                                                       opt):
    from apex_tpu_torch import optimizers

    params = {"w": torch.randn(4, 8), "b": torch.randn(8)}
    kw = dict(lr=0.1, momentum=0.9) if opt == "FusedSGD" else {}
    o = getattr(optimizers, opt)(use_flat_kernel=True, **kw)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        o.step(params, params, o.init(params))


def test_resnet_on_card_path_never_reaches_plain_sgd(dispatch_to_card):
    """The ResNet example's flat step on the card path: convolutions,
    BatchNorm and the loss are PyTorch, the optimizer's flat_sgd wrapper
    refuses the CPU tensors; no plain version runs."""
    step = make_resnet_train_step(10, "O0", optimizer=port_optimizers
                                  .FusedSGD(lr=0.1, momentum=0.9,
                                            use_flat_kernel=True))
    params, stats = init_resnet(torch.Generator().manual_seed(0), 10, 10,
                                device="cpu")
    state = step.init_state(params, stats, "cpu")
    with pytest.raises(RuntimeError, match="flat_sgd kernel needs CUDA"):
        step(*state, torch.zeros(2, 32, 32, 3), torch.zeros(
            2, dtype=torch.long))


@pytest.mark.parametrize("fn", ["flat_scale", "flat_axpby",
                                "flat_l2norm_partials"])
def test_cuda_path_never_reaches_plain_flat_ops(dispatch_to_card, fn):
    x = torch.randn(8, 128)
    calls = {"flat_scale": lambda: mta.flat_scale(x, 0.5),
             "flat_axpby": lambda: mta.flat_axpby(2.0, x, 1.0, x),
             "flat_l2norm_partials": lambda: mta.flat_l2norm_partials(x)}
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        calls[fn]()


def test_cuda_path_backward_never_reaches_plain(monkeypatch,
                                                dispatch_to_card):
    """With the forwards let through (their kernels swapped for the
    saved plain versions), each backward still goes to its kernel
    wrapper, which refuses the CPU tensors; no plain backward runs."""
    monkeypatch.setattr(ln, "layer_norm_fwd_kernel", _plain["ln"])
    monkeypatch.setattr(fa, "attention_fwd_kernel", _plain["fa"])
    monkeypatch.setattr(xent, "xentropy_fwd_kernel", _plain["xent"])
    monkeypatch.setattr(fsm, "masked_softmax_fwd_kernel", _plain["softmax"])
    monkeypatch.setattr(fsm, "causal_softmax_fwd_kernel", _plain["causal"])
    x = torch.randn(4, 16, requires_grad=True)
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    outs = [ln.fused_layer_norm_affine(x, torch.ones(16), torch.zeros(16),
                                       16),
            ln.fused_rms_norm(x, 16),
            fa.flash_attention(q, q, q, causal=True),
            xent.softmax_cross_entropy_loss(
                x, torch.zeros(4, dtype=torch.long)),
            fsm.scaled_masked_softmax(q, torch.zeros((1, 1, 1, 16),
                                                     dtype=torch.int32)),
            fsm.scaled_upper_triang_masked_softmax(q)]
    for out in outs:
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            out.sum().backward()


def test_bert_unfused_on_card_path_never_reaches_plain(dispatch_to_card):
    import dataclasses

    cfg = dataclasses.replace(port_bert.bert_tiny(), fused_attention=False)
    params = port_bert.init_bert(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        port_bert.apply_bert(params, cfg, torch.zeros((1, 4),
                                                      dtype=torch.long))


def test_gpt_on_card_path_never_reaches_plain(dispatch_to_card):
    cfg = port_gpt.gpt_tiny()
    params = port_gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        port_gpt.apply_gpt_unsharded(params, cfg,
                                     torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("use_rope", [False, True], ids=["learned", "rope"])
def test_gpt_training_on_card_path_never_reaches_plain(monkeypatch,
                                                       dispatch_to_card,
                                                       use_rope):
    """The GPT training step with dropout on the card path, the norm and
    attention forwards let through (swapped for the saved plain
    versions): the next kernel wrapper it reaches (the dropout's)
    refuses the CPU tensors; RoPE is plain PyTorch on either device."""
    import dataclasses

    monkeypatch.setattr(ln, "layer_norm_fwd_kernel", _plain["ln"])
    monkeypatch.setattr(fa, "attention_fwd_kernel", _plain["fa"])
    cfg = dataclasses.replace(port_gpt.gpt_tiny(), use_rope=use_rope)
    params = port_gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    step = gpt_train.make_gpt_train_step(cfg, dropout_rng=prng.PRNGKey(0))
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="dropout kernel needs CUDA"):
        step(params, step.opt.init(params), ids, ids)


@pytest.mark.parametrize("fn", ["w8_matmul", "w8_matmul_nobias",
                                "w8_matmul_nk"])
def test_cuda_path_never_reaches_plain_w8(dispatch_to_card, fn):
    from apex_tpu_torch.quant import quantize_tensor

    x = torch.randn(2, 3, 16)
    wq, scale = quantize_tensor(torch.randn(16, 24), -2)
    wn, sn = quantize_tensor(torch.randn(24, 16), -1)
    calls = {"w8_matmul": lambda: w8.w8_matmul(x, wq, scale,
                                               torch.zeros(24)),
             "w8_matmul_nobias": lambda: w8.w8_matmul(x, wq, scale),
             "w8_matmul_nk": lambda: w8.w8_matmul_nk(x, wn, sn)}
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        calls[fn]()


def test_quantized_engine_prefill_never_reaches_plain(monkeypatch,
                                                     dispatch_to_card):
    """A quantized tree's prefill goes to the w8 kernel wrappers (the
    norm and attention kernels swapped for the saved plain versions, so
    the step reaches its first linear), which refuse CPU tensors."""
    from apex_tpu_torch.quant import quantize_params

    monkeypatch.setattr(ln, "layer_norm_fwd_kernel", _plain["ln"])
    monkeypatch.setattr(fa, "attention_fwd_kernel", _plain["fa"])
    cfg = port_gpt.gpt_tiny()
    params = quantize_params(port_gpt.init_gpt(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    eng = port_serving.DecodeEngine(params, cfg, num_slots=1, max_len=16,
                                    device="cpu")
    with pytest.raises(RuntimeError, match="w8_matmul kernel needs CUDA"):
        eng.prefill(0, [3, 4, 5])


@pytest.mark.parametrize("mod", [ln, fa, xent, fsm, mta, w8, prng],
                         ids=["layer_norm", "flash", "xentropy",
                              "fused_softmax", "flat_adam", "w8_matmul",
                              "threefry"])
def test_wrappers_have_no_fallback(mod):
    """No ``try`` in a wrapper module: a failed launch raises."""
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


class _FakeLib:
    """Stands in for a loaded library: ``apx_fn`` returns ``code`` as
    the C entry points return ``cudaGetLastError()``."""

    def __init__(self, code):
        self.apx_fn = lambda *args: code

    def load(self):
        return self

    def apx_error_string(self, code):
        return b"fake error"


@pytest.mark.parametrize("code", [0, 9])
def test_launch_count_moves_only_on_success(code):
    k = cuda_build.Kernel(_FakeLib(code), "apx_fn", [])
    if code:
        with pytest.raises(RuntimeError, match="CUDA error 9.*fake error"):
            k(1, 2)
        assert k.launches == 0
    else:
        k(1, 2)
        k(3, 4)
        assert k.launches == 2


def test_library_path_follows_source_and_flags():
    lib = cuda_build.CudaLibrary("layer_norm")
    assert lib.path.startswith(os.path.join(cuda_build.BUILD_DIR,
                                            "liblayer_norm-"))
    assert lib.path.endswith(".so")
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_OPTIMIZERS = ["FusedAdam", "FusedLAMB", "FusedSGD", "FusedAdagrad",
               "FusedNovoGrad"]


@pytest.mark.parametrize("name", _OPTIMIZERS)
def test_optimizer_signatures_match_the_reference(name):
    """Names, order, kinds and defaults of each constructor's parameters
    against the JAX package's (read from its source with ``ast``: the
    port's tests import no JAX here); a dtype default is compared by its
    name."""
    path = os.path.join(REPO, "apex_tpu", "optimizers",
                        f"{_REF_FILES[name]}.py")
    with open(path) as f:
        mod = ast.parse(f.read(), path)
    init = next(n for c in mod.body if isinstance(c, ast.ClassDef)
                and c.name == name for n in c.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__")
    a = init.args
    pos = a.args[1:]                     # without self
    pos_defaults = [None] * (len(pos) - len(a.defaults)) + a.defaults
    want = [(x.arg, "POSITIONAL_OR_KEYWORD", d) for x, d in zip(
        pos, pos_defaults)] + [(x.arg, "KEYWORD_ONLY", d) for x, d in zip(
            a.kwonlyargs, a.kw_defaults)]
    got = list(inspect.signature(getattr(port_optimizers, name))
               .parameters.values())
    assert [(p.name, p.kind.name) for p in got] == [w[:2] for w in want]
    for p, (_, _, d) in zip(got, want):
        if d is None:
            assert p.default is inspect.Parameter.empty, p.name
        elif isinstance(d, ast.Attribute):   # jnp.float32 -> torch.float32
            assert p.default == getattr(torch, d.attr), p.name
        else:
            assert p.default == ast.literal_eval(d), p.name


_REF_FILES = {"FusedAdam": "fused_adam", "FusedLAMB": "fused_lamb",
              "FusedSGD": "fused_sgd", "FusedAdagrad": "fused_adagrad",
              "FusedNovoGrad": "fused_novograd"}


# ---------------------------------------------------------------------------
# The public surface against the reference: every ported module's public
# functions, classes and methods, by name and parameters (names, order,
# kinds, defaults), read from the reference's source with ``ast`` and from
# the port with ``inspect``.
# ---------------------------------------------------------------------------

# Port modules with no module of the JAX package behind them.
PORT_ONLY = {
    "utils/cuda_build.py": "builds csrc/*.cu with nvcc, binds with ctypes",
    "utils/prng.py": "jax.random's threefry streams (the JAX package calls "
                     "jax.random)",
    "utils/tree.py": "the port's stand-in for jax.tree",
    "models/_convert.py": "carries JAX weight trees across",
    "examples/bert/train.py": "bench.py::_bert_step as a module and CLI",
    "examples/bert/profile_train.py": "a profiler window on the card",
    "examples/gpt/profile_serving.py": "a profiler window on the card",
    "examples/gpt/train.py": "bench.py's GPT tp=1 step (gpt_tp_bench's "
                             "body1) as a module and CLI",
    "examples/gpt/profile_train.py": "a profiler window on the card",
    "examples/imagenet/profile_train.py": "a profiler window on the card",
    "examples/kernel_ab.py": "kernels of two checkouts in one process",
}

# Departures every module takes (the ground rules): no Pallas interpret
# mode and no kernel switch (``interpret=``, ``use_kernel=`` dropped), a
# ``jax.random`` key becomes a ``torch.Generator``, and an entry point may
# take a trailing ``device=``.
_DROPPED = {"interpret", "use_kernel"}
_RENAMED = {"key": "generator"}

# Deliberate departures of one name: "module:name" -> what the port does.
DEPARTURES = {
    "amp/frontend.py:Amp.value_and_grad":
        "no **grad_kwargs: jax.value_and_grad's options (argnums, ...) have "
        "no torch.autograd counterpart",
    "examples/gpt/generate.py:parse_args": "argv=, so tests drive the CLI",
    "examples/gpt/generate.py:main": "argv=, so tests drive the CLI",
    "examples/gpt/pretrain_gpt.py:main": "argv=, so tests drive the CLI",
    "examples/imagenet/main_amp.py:parse_args":
        "argv=, so tests drive the CLI",
    "examples/imagenet/main_amp.py:main": "argv=, so tests drive the CLI",
    "models/bert.py:init_bert": "(cfg, generator): the generator after cfg",
    "models/gpt.py:init_gpt": "(cfg, generator): the generator after cfg",
    "multi_tensor_apply/kernels.py:flat_adam":
        "found_inf=: the overflow skip inside the kernel",
    "multi_tensor_apply/kernels.py:flat_sgd":
        "found_inf=: the overflow skip inside the kernel",
    "multi_tensor_apply/kernels.py:flat_adagrad":
        "found_inf=: the overflow skip inside the kernel",
    "multi_tensor_apply/kernels.py:flat_novograd":
        "tile_counts in place of num_tensors, found_inf=",
    "normalization/fused_layer_norm.py:FusedLayerNorm.init":
        "FusedLayerNorm is an nn.Module: its parameters are its own",
    "normalization/fused_layer_norm.py:FusedLayerNorm.apply":
        "FusedLayerNorm is an nn.Module: call it (apply is Module.apply)",
    "quant/kernels.py:kernel_variant":
        "a TPU tile choice; the C entries choose from pointers and shapes",
    "transformer/functional/flash_attention.py:kernel_variant":
        "a TPU tile choice; the C entries choose from pointers and shapes",
    "utils/platform.py:apply_test_platform_override":
        "Pallas/TPU platform helper: device= takes its place",
    "utils/platform.py:has_tpu":
        "Pallas/TPU platform helper: device= takes its place",
    "utils/platform.py:interpret_default":
        "Pallas/TPU platform helper: device= takes its place",
    "utils/platform.py:pallas_interpret":
        "Pallas/TPU platform helper: device= takes its place",
}

# Names (or parameters) owed to later items of ROADMAP.md queue A. When an
# item lands, delete its entry: the scan then holds every one of its names
# to the reference.
OWED = {
    "A4.1 paged cache": [
        "serving/cache.py:PagedKVCache", "serving/cache.py:max_pages_per_slot",
        "serving/cache.py:init_paged_cache",
        "serving/cache.py:audit_block_tables",
        "serving/decode.py:make_paged_prefill_fn",
        "serving/decode.py:make_paged_decode_fn",
        "serving/decode.py:make_copy_page_fn",
        "serving/scheduler.py:PagedDecodeEngine",
        "serving/scheduler.py:DecodeEngine.check_invariants",
        "serving/scheduler.py:DecodeEngine.pool_snapshot",
        "serving/scheduler.py:DecodeEngine.pool_gauges",
        "serving/scheduler.py:DecodeEngine.pop_admit_charge",
        "quant/kernels.py:kv_quantize", "quant/kernels.py:kv_dequantize"],
    "A4.2 speculative decoding": [
        "serving/decode.py:make_verify_fn",
        "serving/decode.py:make_paged_verify_fn",
        "serving/decode.py:make_tree_verify_fn",
        "serving/decode.py:make_paged_tree_verify_fn",
        "serving/sampling.py:speculative_accept",
        "serving/sampling.py:tree_speculative_accept",
        "serving/scheduler.py:DecodeEngine.__init__",  # spec_k, draft_model,
        # tree_spec, adaptive_spec; injector and tracer (A4.4)
        "serving/scheduler.py:DecodeEngine.draft",
        "serving/scheduler.py:DecodeEngine.draft_batch",
        "serving/scheduler.py:DecodeEngine.draft_tree_batch",
        "serving/scheduler.py:DecodeEngine.verify",
        "serving/scheduler.py:DecodeEngine.tree_verify",
        "serving/scheduler.py:DecodeEngine.commit",
        "serving/scheduler.py:DecodeEngine.sample_grid",
        "serving/scheduler.py:DecodeEngine.prepare_decode"],   # n_new
    "A4.3 chunked prefill": [
        "serving/decode.py:make_chunk_prefill_fn",
        "serving/decode.py:make_paged_chunk_prefill_fn",
        "serving/scheduler.py:DecodeEngine.begin_chunk_prefill",
        "serving/scheduler.py:DecodeEngine.chunk_prefill",
        "serving/scheduler.py:DecodeEngine.finish_chunk_prefill"],
    "A4.4 faults, tracer and tenancy": [
        f"serving/health.py:{n}" for n in (
            "PoolExhausted", "RetryBudgetExhausted", "DeadlineExceeded",
            "AdmissionRejected", "LivelockError", "PoolInvariantError",
            "TransferFailed", "TransferCorrupt", "ReshardFailed",
            "ReplicaUnavailable", "SpillFailed", "PromoteFailed",
            "StreamFailed", "QuotaExhausted", "SloViolation",
            "ReplicaHealth", "ServingStats", "snapshot",
            "ServingError.__init__", "RequestOutcome.ok",
            "RequestOutcome.error", "RequestOutcome.retries",
            "RequestOutcome.tenant_id", "RequestOutcome.slo")] + [
        "serving/scheduler.py:Request.deadline_ticks",
        "serving/scheduler.py:Request.tenant_id",
        "serving/scheduler.py:ContinuousBatchingScheduler.__init__",
        "serving/scheduler.py:ContinuousBatchingScheduler.clock",
        "serving/scheduler.py:ContinuousBatchingScheduler.advance_clock",
        "serving/scheduler.py:ContinuousBatchingScheduler.submit"],
    "A4.5 tensor-parallel serving": [
        f"serving/decode.py:make_tp_{n}_fn" for n in (
            "prefill", "decode", "verify", "paged_prefill", "paged_decode",
            "paged_verify", "tree_verify", "chunk_prefill",
            "paged_chunk_prefill", "paged_tree_verify")],
    "A5 optimizer and amp tier": [
        "amp/frontend.py:Amp.__init__", "amp/frontend.py:initialize",
        "amp/frontend.py:Amp.master_params", "amp/frontend.py:Amp.autocast",
        "amp/frontend.py:Amp.state_dict", "amp/frontend.py:Amp.load_state_dict",
        "optimizers/fused_adam.py:FusedAdam.step",
        "optimizers/fused_lamb.py:FusedLAMB.step",
        "optimizers/fused_sgd.py:FusedSGD.step",
        "optimizers/fused_adagrad.py:FusedAdagrad.step",
        "optimizers/fused_novograd.py:FusedNovoGrad.step",
        "multi_tensor_apply/kernels.py:flat_lamb"],  # grad_scale, grad_norm
    "A6 data and model parallelism": [
        "models/gpt.py:GPTModel",
        "models/bert.py:bert_partition_specs",
        "models/gpt.py:gpt_partition_specs",
        "models/gpt.py:gpt_to_pipeline_params",
        "models/gpt.py:gpt_pipeline_partition_specs",
        "models/gpt.py:gpt_pipeline_model", "models/gpt.py:gpt_tp_bench",
        "models/layers.py:batchnorm",                  # axis_index_groups
        "quant/params.py:quant_partition_specs",
        "serving/cache.py:cache_partition_specs",
        "serving/cache.py:paged_cache_partition_specs",
        "optimizers/fused_adam.py:FusedAdam.state_partition_specs"],
}


def _ported_modules():
    """Port modules (paths under apex_tpu_torch/, ``__init__`` files
    aside) and their reference files: ``apex_tpu/x`` for ``x``, the
    repo's ``examples/`` for ``examples/``; None where there is none."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames.sort()
        for f in sorted(filenames):
            if not f.endswith(".py") or f == "__init__.py":
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), PORT)
            ref = os.path.join(REPO, rel) if rel.startswith("examples/") \
                else os.path.join(REPO, "apex_tpu", rel)
            out[rel] = ref if os.path.exists(ref) else None
    return out


_MODULES = _ported_modules()


def _default(node, namespace):
    """A reference default as a value: literals and arithmetic, the
    port module's names for the reference's (``trunc_normal``,
    ``AttnMaskType.padding``), ``jnp.<dtype>`` as ``torch.<dtype>``;
    otherwise its source text."""
    if node is None:
        return inspect.Parameter.empty
    src = ast.unparse(node)
    try:
        return eval(src, {"__builtins__": {}, "jnp": torch},  # noqa: S307
                    namespace)
    except (NameError, AttributeError, TypeError):
        return src


def _ref_params(fn, namespace):
    a = fn.args
    pos = a.posonlyargs + a.args
    if pos and pos[0].arg in ("self", "cls"):
        pos = pos[1:]
    dflt = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(x.arg, "P", d) for x, d in zip(pos, dflt)]
    out += [("*" + a.vararg.arg, "V", None)] if a.vararg else []
    out += [(x.arg, "K", d) for x, d in zip(a.kwonlyargs, a.kw_defaults)]
    out += [("**" + a.kwarg.arg, "VK", None)] if a.kwarg else []
    return [(_RENAMED.get(n, n), k, _default(d, namespace))
            for n, k, d in out if n not in _DROPPED]


_KIND = {"POSITIONAL_ONLY": "P", "POSITIONAL_OR_KEYWORD": "P",
         "KEYWORD_ONLY": "K", "VAR_POSITIONAL": "V", "VAR_KEYWORD": "VK"}


def _port_params(obj):
    ps = list(inspect.signature(obj).parameters.values())
    if ps and ps[0].name in ("self", "cls"):
        ps = ps[1:]
    star = {"VAR_POSITIONAL": "*", "VAR_KEYWORD": "**"}
    return [(star.get(p.kind.name, "") + p.name, _KIND[p.kind.name],
             p.default) for p in ps if p.name != "device"]


def _same(ref, port):
    if [(n, k) for n, k, _ in ref] != [(n, k) for n, k, _ in port]:
        return False
    for (_, _, d), (_, _, e) in zip(ref, port):
        if isinstance(e, enum.Enum) or callable(e) or isinstance(
                e, torch.dtype):
            if d is not e:
                return False
        elif not (d == e or (d != d and e != e)):
            return False
    return True


def _is_record(node):
    """A dataclass or a NamedTuple in the reference's source."""
    return any("dataclass" in ast.unparse(d) for d in node.decorator_list) \
        or any("NamedTuple" in ast.unparse(b) for b in node.bases)


def _port_fields(obj):
    """{field: default} of a port dataclass or NamedTuple (empty where
    a field has none); None for another kind of class."""
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out[f.name] = (
                f.default if f.default is not dataclasses.MISSING
                else f.default_factory()
                if f.default_factory is not dataclasses.MISSING
                else inspect.Parameter.empty)
        return out
    if isinstance(obj, type) and issubclass(obj, tuple) \
            and hasattr(obj, "_fields"):
        return {n: obj._field_defaults.get(n, inspect.Parameter.empty)
                for n in obj._fields}
    return None


def _field_findings(key, node, obj, ns):
    """``key.field`` for each field of the reference record ``node``
    that the port's class lacks or gives another default, and for each
    field the port adds."""
    ref = {s.target.id: _default(s.value, ns) for s in node.body
           if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)}
    port = _port_fields(obj)
    if port is None:
        return [f"{key}.{n}" for n in ref]
    found = []
    for n, d in ref.items():
        if n not in port or not _same([(n, "F", d)], [(n, "F", port[n])]):
            found.append(f"{key}.{n}")
    return found + [f"{key}.{n}" for n in port if n not in ref]


def _surface_findings(rel):
    """The "module:name" keys where the port departs from the reference:
    a public function, class or method that is missing, or whose
    parameters differ; and "module:Class.field" keys where a reference
    dataclass or NamedTuple's field is missing, has another default, or
    the port adds one."""
    with open(_MODULES[rel]) as f:
        tree = ast.parse(f.read())
    mod = importlib.import_module(
        "apex_tpu_torch." + rel[:-3].replace("/", "."))
    ns = vars(mod)
    found = []
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                or node.name.startswith("_"):
            continue
        obj = getattr(mod, node.name, None)
        key = f"{rel}:{node.name}"
        if obj is None:
            found.append(key)
            continue
        if isinstance(node, ast.FunctionDef):
            if not _same(_ref_params(node, ns), _port_params(obj)):
                found.append(key)
            continue
        if _is_record(node):
            found += _field_findings(key, node, obj, ns)
        for m in node.body:
            if not isinstance(m, ast.FunctionDef) or (
                    m.name.startswith("_") and m.name != "__init__"):
                continue
            mkey = f"{key}.{m.name}"
            pm = inspect.getattr_static(obj, m.name, None)
            if pm is None or pm is object.__init__:
                found.append(mkey)
            elif isinstance(pm, property):
                continue
            elif not _same(_ref_params(m, ns),
                           _port_params(getattr(obj, m.name))):
                found.append(mkey)
    return found


def test_field_scan_finds_a_missing_or_changed_field(monkeypatch):
    """The scan reports a reference dataclass field the port lacks, one
    whose default differs, and one the port adds, by
    ``module:Class.field`` (GPTConfig lacked six fields unseen before
    fields were scanned); a NamedTuple's fields likewise."""
    from typing import NamedTuple

    kept = [(f.name, f.type, dataclasses.field(
        default=500.0 if f.name == "rope_base" else f.default))
        for f in dataclasses.fields(port_gpt.GPTConfig) if f.name != "remat"]
    monkeypatch.setattr(port_gpt, "GPTConfig", dataclasses.make_dataclass(
        "GPTConfig", kept + [("extra", int, dataclasses.field(default=0))],
        frozen=True))
    found = _surface_findings("models/gpt.py")
    assert {"models/gpt.py:GPTConfig.remat",
            "models/gpt.py:GPTConfig.rope_base",
            "models/gpt.py:GPTConfig.extra"} <= set(found)
    cache = importlib.import_module("apex_tpu_torch.serving.cache")

    class KVCache(NamedTuple):
        k: torch.Tensor
        v: torch.Tensor

    monkeypatch.setattr(cache, "KVCache", KVCache)
    assert "serving/cache.py:KVCache.lengths" in _surface_findings(
        "serving/cache.py")


def test_gpt_config_has_every_reference_field():
    """GPTConfig carries the reference's fields with its defaults, and
    gpt_medium() checkpoints its layers as the reference's does."""
    assert [f.name for f in dataclasses.fields(port_gpt.GPTConfig)] == [
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "ffn_hidden_size", "max_position_embeddings", "layer_norm_eps",
        "use_rope", "rope_base", "hidden_dropout", "remat", "remat_policy",
        "sequence_parallel", "context_parallel", "context_parallel_impl",
        "gradient_accumulation_fusion"]
    assert port_gpt.gpt_medium().remat is True
    assert not _field_findings("models/gpt.py:GPTConfig", next(
        n for n in ast.parse(open(_MODULES["models/gpt.py"]).read()).body
        if isinstance(n, ast.ClassDef) and n.name == "GPTConfig"),
        port_gpt.GPTConfig, vars(port_gpt))


def test_port_only_modules_are_listed():
    """Every port module without a reference is listed (prng.py among
    them), and every listed one exists."""
    assert {r for r, ref in _MODULES.items() if ref is None} == \
        set(PORT_ONLY)
    assert "utils/prng.py" in PORT_ONLY


@pytest.mark.parametrize("rel", sorted(r for r, ref in _MODULES.items()
                                       if ref is not None))
def test_public_surface_matches_the_reference(rel):
    """Names and parameters against the reference, minus the listed
    departures and the names owed to later queue-A items: a new gap
    fails, and so does a listed gap that is gone (delete its entry)."""
    owed = {k for keys in OWED.values() for k in keys}
    listed = {k for k in set(DEPARTURES) | owed
              if k.startswith(rel + ":")}
    assert sorted(_surface_findings(rel)) == sorted(listed)
