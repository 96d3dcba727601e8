"""Serving across several devices (``mesh=``) in the port vs JAX's mesh, on the CPU.

The model of ``tests/test_parallel.py::test_mesh_sharded_inference_matches_single_device``
(width 0.25, hidden 16, one LSTM layer, both heads, 32x64, fp32), its
weights seeded and sharpened so that lines decode to different strings.
JAX serves it on the test session's 8 virtual CPU devices
(``OCRInference(mesh=True)``); the port on eight CPU replicas
(``mesh=["cpu"] * 8``), each decoding its block of every batch in its own
thread.  Held:

* every decode (attention greedy and beam, CTC greedy and beams on the
  device and on the host, the four ``predict_serving`` methods, the three
  long-line decodes) gives the strings of the port's engine without a mesh
  (and its confidences within 1e-5) and of JAX's mesh engine, with a batch
  size that rounds up (6 images at
  batch 4 over 8 replicas: one batch of 8); the gathered greedy logits are
  the one-replica engine's within rtol 1e-5 / atol 1e-6, in row order;
* calibration: every replica holds the same ranges, the element-wise max of
  the one-replica engine's ranges over each replica's block, within rtol
  1e-5 of the one-replica engine over whole chunks (the CPU's convolutions
  round a one-row batch otherwise than an eight-row one) and of JAX's
  ``quant_stats``; the decodes and ``save_calibration`` follow;
* artifacts (``ctc_greedy``, ``ctc_long``, ``hybrid_long``) loaded with a
  mesh equal the same artifact without one; a batch that does not tile
  raises, and an engine with a mesh does not export (JAX's messages);
* ``python -m rcnn_ocr_tpu_torch.serve --mesh`` (four CPU replicas through
  a test hook) answers as the engine without a mesh, also after a SIGHUP
  reload, which rebuilds the engine with the same mesh;
* ``python -m rcnn_ocr_tpu_torch.serve_loadtest`` against a port daemon
  gives the keys of ``tools/serve_loadtest.py``'s result and final line;
* each kernel launches under its tensor's card's device guard and on that
  card's stream, whatever card the thread has current (fails on a
  launcher that takes the current device's stream);
* the replicas: ``serving_devices``' rules and a replica's exception
  failing the call.
"""

import contextlib
import importlib.util
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from rcnn_ocr_tpu.inference import OCRInference as JaxOCRInference  # noqa: E402
from rcnn_ocr_tpu_torch import serve_loadtest  # noqa: E402
from rcnn_ocr_tpu_torch import serving as port_serving  # noqa: E402
from rcnn_ocr_tpu_torch.export import ServingArtifact, export_serving_artifact  # noqa: E402
from rcnn_ocr_tpu_torch.inference import OCRInference  # noqa: E402
from rcnn_ocr_tpu_torch.interop.jax_params import to_jax_variables  # noqa: E402
from rcnn_ocr_tpu_torch.models.rcnn import RCNN, init_train_params  # noqa: E402
from rcnn_ocr_tpu_torch.ops import bilstm_scan, kernels, se_scale  # noqa: E402
from rcnn_ocr_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from rcnn_ocr_tpu_torch.vocab.charset import Charset  # noqa: E402
from tests.test_torch_port_beam_engine import sharpen  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = ["<PAD>", "<SOS>", "<EOS>", "<BLANK>", "a", "b", "c"]
HIDDEN, WIDTH, IMG_H, IMG_W, MAX_LEN = 16, 0.25, 32, 64, 4
MESH = ["cpu"] * 8
STATS_RTOL = 1e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    cs = Charset.from_tokens(TOKENS)
    model = RCNN(num_classes=len(TOKENS), hidden_size=HIDDEN, width_mult=WIDTH, lstm_layers=1,
                 with_ctc_head=True, sos_id=cs.sos_id, eos_id=cs.eos_id, pad_id=cs.pad_id,
                 blank_id=cs.blank_id).eval()
    init_train_params(model, torch.Generator().manual_seed(5))
    sharpen(model)
    root = tmp_path_factory.mktemp("mesh")
    ckpt = root / "w_weights.msgpack"
    ckpt.write_bytes(serialization.msgpack_serialize(to_jax_variables(model)))
    charset = root / "cs.txt"
    charset.write_text("\n".join(TOKENS) + "\n", encoding="utf-8")
    return str(ckpt), str(charset)


def _port(files, **kw):
    ckpt, charset = files
    return OCRInference(ckpt, charset, device="cpu", dtype=torch.float32, img_h=IMG_H,
                        img_w=IMG_W, **kw)


@pytest.fixture(scope="module")
def engines(files):
    """The port without a mesh, the port over eight CPU replicas and JAX over
    its eight virtual devices."""
    ckpt, charset = files
    theirs = JaxOCRInference(ckpt, charset, dtype=jnp.float32, mesh=True, verbose=False,
                             img_h=IMG_H, img_w=IMG_W)
    assert int(np.prod(list(theirs._mesh.shape.values()))) == 8
    return _port(files), _port(files, mesh=MESH), theirs


def _images(n=6, seed=0):
    """Flat colour lines crossed by colour bars, 20-32 high and up to twice
    the canvas wide (so resize-pad shrinks, grows and pads)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(20, 33)), int(rng.integers(40, 2 * IMG_W))
        img = np.full((h, w, 3), int(rng.integers(0, 256)), np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            x0 = int(rng.integers(0, w - 4))
            img[:, x0 : x0 + int(rng.integers(4, 24))] = rng.integers(0, 256, size=3)
        out.append(img)
    return out


def _texts(rows):
    return [r[0] if isinstance(r, tuple) else r for r in rows]


def _same(got, want, what):
    assert _texts(got) == _texts(want), what
    if got and isinstance(got[0], tuple):
        np.testing.assert_allclose([c for _, c in got], [c for _, c in want], rtol=1e-5,
                                   atol=1e-5, err_msg=what)


SERVING = dict(max_length=MAX_LEN, batch_size=4, canvas=(IMG_H, 2 * IMG_W))
DECODES = {
    "attention": lambda e, x: e.predict(x, max_length=MAX_LEN, batch_size=4,
                                        return_confidence=True),
    "attention_beam": lambda e, x: e.predict(x, max_length=MAX_LEN, batch_size=4, beam_width=3,
                                             return_confidence=True),
    "ctc_greedy": lambda e, x: e.predict_ctc(x, batch_size=4, return_confidence=True),
    "ctc_beam_device": lambda e, x: e.predict_ctc(x, batch_size=4, method="beam", beam_width=4,
                                                  prune_k=5, return_confidence=True),
    "ctc_beam_host": lambda e, x: e.predict_ctc(x, batch_size=4, method="beam", beam_width=4,
                                                device_beam=False, return_confidence=True),
    **{f"serving_{m}": (lambda m: lambda e, x: e.predict_serving(
        x, method=m, beam_width=3, return_confidence=True, **SERVING))(m)
       for m in ("attention", "attention_beam", "ctc_greedy", "ctc_beam")},
}


@pytest.mark.parametrize("decode", list(DECODES))
def test_mesh_decodes_equal_one_replica_and_jax(engines, decode):
    single, meshed, theirs = engines
    imgs = _images()
    run = DECODES[decode]
    got = run(meshed, imgs)
    assert len(got) == 6
    _same(got, run(single, imgs), f"{decode}: mesh vs no mesh")
    # strings against JAX: a beam's confidence is its winner's, and among
    # hypotheses of one string the two packages' fp32 sums may rank
    # otherwise (1e-4 relative on one attention-beam row here)
    assert _texts(got) == _texts(run(theirs, imgs)), f"{decode}: port mesh vs JAX mesh"


def test_batches_round_up_and_rows_keep_their_order(engines):
    single, meshed, _ = engines
    assert len(meshed._replicas) == 8 and meshed._mesh == [torch.device("cpu")] * 8
    assert [meshed._round_batch(b) for b in (1, 4, 8, 9)] == [8, 8, 8, 16]
    assert single._round_batch(4) == 4
    imgs = _images(8, seed=3)
    x = np.stack([single._preprocess(img, None) for img in imgs])
    run = single._greedy_fn(MAX_LEN + 1)
    with torch.inference_mode():
        want = run(torch.from_numpy(x))
    got = meshed._call(meshed._greedy_fn(MAX_LEN + 1), x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-6)
    # the CTC head reads these rows apart, so a block out of place would show
    texts = meshed.predict_ctc(imgs, batch_size=8)
    assert len(set(texts)) >= 5 and texts == single.predict_ctc(imgs, batch_size=8)
    assert [meshed.predict_ctc(img) for img in imgs] == texts


@pytest.mark.parametrize("method", ["ctc_greedy", "hybrid", "attention"])
def test_long_lines_under_a_mesh(engines, method):
    single, meshed, theirs = engines
    rng = np.random.default_rng(11)
    lines = _images(3, seed=4) + [rng.integers(0, 256, (30, 300, 3)).astype(np.uint8),
                                  rng.integers(0, 256, (24, 170, 3)).astype(np.uint8)]
    kw = dict(method=method, batch_size=4, max_length=MAX_LEN)
    if method == "attention":
        kw["merge"] = "text"
    got = meshed.predict_long(lines, **kw)
    assert got == single.predict_long(lines, **kw)
    assert got == theirs.predict_long(lines, **kw)


def _absmax(model):
    return {k: float(v) for k, v in model.named_buffers() if k.endswith("act_absmax")}


def test_calibration_under_a_mesh(files, tmp_path):
    ckpt, charset = files
    imgs = _images(6, seed=7)
    meshed = _port(files, quantize=True, mesh=MESH)
    meshed.calibrate(imgs, batch_size=8)
    ranges = [_absmax(m) for m in meshed._models]
    assert len(ranges[0]) == 24 and all(r == ranges[0] for r in ranges)
    # the join is exact: the max over each replica's one-row block (the
    # chunk's last two rows repeat its last image)
    blocks = []
    for img in imgs:
        one = _port(files, quantize=True)
        one.calibrate([img], batch_size=1)
        blocks.append(_absmax(one.model))
    assert ranges[0] == {k: max(b[k] for b in blocks) for k in ranges[0]}
    whole = _port(files, quantize=True)
    whole.calibrate(imgs, batch_size=8)
    theirs = JaxOCRInference(ckpt, charset, dtype=jnp.float32, quantize=True, mesh=True,
                             verbose=False, img_h=IMG_H, img_w=IMG_W)
    theirs.calibrate(imgs, batch_size=8)
    want = {jax.tree_util.keystr(p): float(v) for p, v in
            jax.tree_util.tree_leaves_with_path(theirs.variables["quant_stats"])}
    got = {jax.tree_util.keystr(p): float(v) for p, v in
           jax.tree_util.tree_leaves_with_path(meshed.variables["quant_stats"])}
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=STATS_RTOL, atol=0, err_msg=key)
    for key, value in _absmax(whole.model).items():
        np.testing.assert_allclose(ranges[0][key], value, rtol=STATS_RTOL, atol=0, err_msg=key)
    texts = meshed.predict(imgs, max_length=MAX_LEN, batch_size=8)
    assert texts == whole.predict(imgs, max_length=MAX_LEN, batch_size=8)
    assert meshed.predict_ctc(imgs, batch_size=8) == whole.predict_ctc(imgs, batch_size=8)
    path = str(tmp_path / "cal.msgpack")
    meshed.save_calibration(path)
    reopened = OCRInference(path, charset, device="cpu", dtype=torch.float32, quantize=True,
                            img_h=IMG_H, img_w=IMG_W)
    assert _absmax(reopened.model) == ranges[0]
    assert reopened.predict(imgs, max_length=MAX_LEN, batch_size=8) == texts


def test_artifacts_under_a_mesh(engines, tmp_path):
    single, meshed, _ = engines
    imgs = _images(5, seed=13)
    rng = np.random.default_rng(17)
    lines = imgs + [rng.integers(0, 256, (32, 300, 3)).astype(np.uint8)]
    for method, batch in (("ctc_greedy", imgs), ("ctc_long", lines), ("hybrid_long", lines)):
        out = str(tmp_path / method)
        export_serving_artifact(single, out, method=method, batch_size=8,
                                canvas=(IMG_H, 2 * IMG_W), max_length=MAX_LEN, prune_k=5)
        plain = ServingArtifact.load(out, device="cpu")
        sharded = ServingArtifact.load(out, device="cpu", mesh=MESH)
        assert len(sharded._replicas) == 8
        assert sharded.predict(batch) == plain.predict(batch), method
    bad = str(tmp_path / "bad")
    export_serving_artifact(single, bad, method="ctc_greedy", batch_size=6,
                            canvas=(IMG_H, IMG_W))
    with pytest.raises(ValueError, match="does not tile"):
        ServingArtifact.load(bad, device="cpu", mesh=MESH)
    with pytest.raises(ValueError, match=re.escape("ServingArtifact.load(dir, mesh=True)")):
        export_serving_artifact(meshed, str(tmp_path / "refused"), method="ctc_greedy")
    assert not os.path.exists(str(tmp_path / "refused"))


# --- the daemon and the load-test tool ------------------------------------------------

_MESH_DAEMON = r"""
import sys
import torch
from rcnn_ocr_tpu_torch import export, inference, serve
from rcnn_ocr_tpu_torch.parallel import mesh

def four_cpu_replicas(m, device):
    if m is True and torch.device(device).type == "cpu":
        print("mesh: 4 cpu replicas", flush=True)
        return [torch.device("cpu")] * 4
    return mesh.serving_devices(m, device)

inference.serving_devices = export.serving_devices = four_cpu_replicas
serve.main(sys.argv[1:])
"""


def _png(img):
    from rcnn_ocr_tpu_torch.data.image_io import png_encode

    return png_encode(img)


def _post(base, body):
    req = urllib.request.Request(base + "/predict", data=body,
                                 headers={"Content-Type": "image/png"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["texts"]


def _read_until(lines, pattern, timeout=120):
    deadline, seen = time.monotonic() + timeout, []
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        seen.append(line)
        m = re.search(pattern, line)
        if m:
            return m
    raise AssertionError(f"no {pattern!r} in the daemon's output: {seen}")


def test_serve_mesh_answers_as_one_replica_and_keeps_its_mesh_on_reload(files):
    ckpt, charset = files
    argv = ["--model", ckpt, "--charset", charset, "--img-h", str(IMG_H), "--img-w", str(IMG_W),
            "--canvas", f"{IMG_H},{2 * IMG_W}", "--batch-size", "4", "--max-length",
            str(MAX_LEN), "--port", "0", "--device", "cpu", "--method", "attention", "--mesh",
            "--max-wait-ms", "0"]
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen([sys.executable, "-c", _MESH_DAEMON, *argv], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: ([lines.put(x) for x in proc.stdout], lines.put(None)),
                     daemon=True).start()
    try:
        _read_until(lines, r"mesh: 4 cpu replicas")
        base = _read_until(lines, r"Serving on (http://\S+)").group(1)
        imgs = _images(4, seed=21)
        # the daemon's engine without a mesh: bf16, the default
        want = OCRInference(ckpt, charset, device="cpu", img_h=IMG_H, img_w=IMG_W).predict_serving(
            imgs, method="attention", batch_size=4, canvas=(IMG_H, 2 * IMG_W), max_length=MAX_LEN)
        assert [_post(base, _png(img))[0] for img in imgs] == want
        proc.send_signal(signal.SIGHUP)
        _read_until(lines, r"mesh: 4 cpu replicas")  # the rebuild takes the mesh again
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
                if "ocr_engine_swaps_total 1" in resp.read().decode():
                    break
            time.sleep(0.1)
        else:
            pytest.fail("the daemon never swapped engines after SIGHUP")
        assert [_post(base, _png(img))[0] for img in imgs] == want
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _jax_loadtest():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_loadtest", os.path.join(REPO, "tools", "serve_loadtest.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_loadtest_tool_matches_the_jax_tool(engines, monkeypatch, capsys):
    single = engines[0]
    fn = port_serving.serving_predict_fn(single, method="ctc_greedy", batch_size=4,
                                         canvas=(IMG_H, 2 * IMG_W))
    server = port_serving.OCRServer(fn, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.address[:2]
    base = f"http://{host}:{port}"
    theirs = _jax_loadtest()
    try:
        body = _png(_images(1, seed=2)[0])
        got = serve_loadtest.run_loadtest(base, body, n_requests=12, concurrency=4)
        want = theirs.run_loadtest(base, body, n_requests=12, concurrency=4)
        assert _keys(got) == _keys(want)
        assert got["ok"] == 12 and got["errors"] == 0
        assert got["server"]["images_served"] == 12 and got["server"]["engine_errors"] == 0
        assert 1 <= got["server"]["engine_batches"] <= 12
        assert got["latency_ms"]["p99"] >= got["latency_ms"]["p50"] > 0
        # the command lines: the same flags, a final JSON line with the same keys
        argv = ["--url", base, "--requests", "4", "--concurrency", "2"]
        assert serve_loadtest.main(argv) == 0
        ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        monkeypatch.setattr(sys, "argv", ["serve_loadtest.py", *argv])
        assert theirs.main() == 0
        jaxs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert _keys(ours) == _keys(jaxs) and ours["ok"] == jaxs["ok"] == 4
    finally:
        server.close()
        thread.join(timeout=10)


def test_synthetic_line_is_a_png_the_daemon_decodes():
    from rcnn_ocr_tpu_torch.data.image_io import imdecode

    img = imdecode(serve_loadtest._synthetic_png())
    assert img.shape == (64, 512, 3) and img.dtype == np.uint8
    assert img.min() < 64 and img.max() == 255


# --- the kernels launch on their tensor's card ---------------------------------------

class _Stream:
    def __init__(self, index):
        self.cuda_stream = 1000 + index


@contextlib.contextmanager
def _fake_cards(monkeypatch):
    """A CPU stand-in for two cards: the thread's current device (0) and
    ``torch.cuda.device`` / ``current_stream`` as the CUDA build keeps them."""
    current = [0]

    @contextlib.contextmanager
    def device(d):
        prev, current[0] = current[0], torch.device(d).index
        try:
            yield
        finally:
            current[0] = prev

    def current_stream(device=None):
        return _Stream(current[0] if device is None else torch.device(device).index)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    yield current


@pytest.mark.parametrize("kernel", [kernels.SE_SCALE, kernels.BILSTM_SCAN],
                         ids=lambda k: k.name)
def test_launch_and_plan_run_on_the_tensors_card(kernel, monkeypatch):
    """The entry point runs with the tensor's card (cuda:1) current and gets
    cuda:1's stream, while the thread's current card is 0."""
    calls = []
    with _fake_cards(monkeypatch) as current:
        monkeypatch.setattr(kernel, "_fn", lambda *args: calls.append((current[0], args[-1])) or 0)
        monkeypatch.setattr(kernel, "_plan_fn",
                            lambda *args: calls.append((current[0], "plan")) or 0)
        before = kernel.launches
        kernel.launch(torch.device("cuda", 1), 11, 22, 33)
        assert current[0] == 0 and kernel.launches == before + 1
        kernel.plan(torch.device("cuda", 1), 4, 5)
        assert current[0] == 0
    assert calls == [(1, 1001), (1, "plan")]


def test_wrappers_launch_on_their_tensors_device(monkeypatch):
    """``_launch`` hands its tensor's own device to the launcher."""
    seen = []
    for kernel in (kernels.SE_SCALE, kernels.BILSTM_SCAN):
        monkeypatch.setattr(kernel, "launch", lambda device, *args: seen.append(device))
    x = torch.ones(2, 3, 3, 16)
    se_scale._launch(x, torch.ones(16, 2), torch.ones(2, 16))
    bilstm_scan._launch(torch.ones(4, 2, 3, 32), torch.ones(2, 8, 32), 8)
    assert seen == [x.device, x.device]
    routes = []
    monkeypatch.setattr(kernels.SE_SCALE, "plan", lambda dev, *a: routes.append(dev) or [0] * 4)
    monkeypatch.setattr(kernels.BILSTM_SCAN, "plan", lambda dev, *a: routes.append(dev) or [0] * 4)
    se_scale.route((2, 4, 4, 64), 4, torch.float32, device=torch.device("cuda", 1))
    bilstm_scan.route(8, 16, torch.float32, device=torch.device("cuda", 1))
    assert routes == [torch.device("cuda", 1)] * 2


# --- the replicas ---------------------------------------------------------------------

def test_serving_devices(monkeypatch):
    assert port_mesh.serving_devices(None, "cpu") is None
    assert port_mesh.serving_devices(False, "cuda") is None
    assert port_mesh.serving_devices(True, "cpu") == [torch.device("cpu")]
    assert port_mesh.serving_devices(("cpu", "cpu"), "cpu") == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is visible"):
        port_mesh.serving_devices(True, "cuda")
    with pytest.raises(ValueError, match="not a cpu device"):
        port_mesh.serving_devices(["cpu", "cuda:0"], "cpu")
    with pytest.raises(ValueError, match="empty"):
        port_mesh.serving_devices([], "cpu")
    with pytest.raises(TypeError, match="sequence of devices"):
        port_mesh.serving_devices("cpu", "cpu")


def test_a_replicas_failure_fails_the_call():
    replicas = port_mesh.ReplicaSet([torch.device("cpu")] * 4, mesh=True)
    blocks = replicas.run(lambda i, lo, hi: (i, lo, hi, threading.current_thread().name), 8)
    assert [b[:3] for b in blocks] == [(0, 0, 2), (1, 2, 4), (2, 4, 6), (3, 6, 8)]
    assert len({b[3] for b in blocks}) == 4 and all("replica" in b[3] for b in blocks)

    def work(i, lo, hi):
        if i == 2:
            raise KeyError("replica 2 failed")
        return i

    with pytest.raises(KeyError, match="replica 2 failed"):
        replicas.run(work, 8)
    with pytest.raises(ValueError, match="does not tile"):
        replicas.run(work, 6)
    with kernels.plain_only():  # the caller's plain_only reaches every replica
        assert replicas.run(lambda i, lo, hi: kernels.plain_forced(), 4) == [True] * 4
    assert replicas.run(lambda i, lo, hi: kernels.plain_forced(), 4) == [False] * 4
