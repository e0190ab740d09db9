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
  ``torch.float32``)."""

import ast
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
    "scaler_init_state", "init_resnet", "resnet_step_init_state"])
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

    for mod in (ln, fa, xent, fsm, mta, w8):
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
                      (w8, "w8_matmul_nk_plain")):
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


@pytest.mark.parametrize("mod", [ln, fa, xent, fsm, mta, w8],
                         ids=["layer_norm", "flash", "xentropy",
                              "fused_softmax", "flat_adam", "w8_matmul"])
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
