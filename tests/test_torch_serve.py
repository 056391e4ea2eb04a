"""The port's serving plane on the CPU (``device="cpu"``).

Bucket math and batching semantics as in ``tests/test_serve.py``: padding
rows never change valid rows, oversize requests chunk, a mixed request
stream makes exactly one warm-up ``compile`` event per bucket (all
``phase="serve_aot"``), and the events file validates under the port's
schema and is read by tpudist's own ``summarize``.
"""

import json

import numpy as np
import pytest
import torch

from tpudist_torch import telemetry as telemetry_lib
from tpudist_torch.models.vit import VisionTransformer
from tpudist_torch.ops import flash_attention as fa
from tpudist_torch.serve import __main__ as serve_cli
from tpudist_torch.serve.batching import (ContinuousBatcher, pad_to_bucket,
                                          parse_buckets, pick_bucket)
from tpudist_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.torch_port

BUCKETS = (1, 2, 4)


def _tiny_model(flash=True):
    m = VisionTransformer(8, 64, 2, 4, 128, 10, image_size=32, flash=flash)
    m.reset_parameters(torch.Generator().manual_seed(0))
    return m.eval()


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 32, 32, 3)).astype(np.float32)


def _direct(model, images):
    with torch.inference_mode():
        return model(torch.from_numpy(images)).numpy()


def test_bucket_math():
    assert parse_buckets("8,1, 4,2,2") == (1, 2, 4, 8)
    with pytest.raises(ValueError):
        parse_buckets("0,2")
    assert [pick_bucket(n, BUCKETS) for n in (1, 2, 3, 4, 9)] == \
        [1, 2, 4, 4, 4]
    x = np.ones((3, 2), np.float32)
    assert pad_to_bucket(x, 4).shape == (4, 2)
    assert not pad_to_bucket(x, 4)[3].any()
    with pytest.raises(ValueError, match="chunk"):
        pad_to_bucket(x, 2)


def test_padding_rows_never_change_valid_rows():
    model = _tiny_model()
    eng = ServeEngine(model, image_size=32, buckets=BUCKETS, device="cpu")
    imgs = _images(3)
    out = eng.infer(imgs)                   # padded to bucket 4
    assert eng.last_info == [{"bucket": 4, "n_valid": 3,
                              "seconds": eng.last_info[0]["seconds"]}]
    for i in range(3):
        np.testing.assert_allclose(out[i:i + 1], _direct(model, imgs[i:i + 1]),
                                   rtol=1e-5, atol=1e-5)


def test_oversize_request_chunks():
    model = _tiny_model()
    eng = ServeEngine(model, image_size=32, buckets=BUCKETS, device="cpu")
    imgs = _images(7, seed=1)
    out = eng.infer(imgs)
    assert out.shape == (7, 10)
    assert [(c["bucket"], c["n_valid"]) for c in eng.last_info] == \
        [(4, 4), (4, 3)]
    np.testing.assert_allclose(out, _direct(model, imgs), rtol=1e-5,
                               atol=1e-5)


def test_mixed_stream_warms_each_bucket_once_and_summarize_reads_it(tmp_path):
    tel = telemetry_lib.Telemetry(str(tmp_path), rank=0)
    tel.emit("run_start", platform="cpu", n_devices=1, arch="vit_tiny",
             global_batch=BUCKETS[-1])
    launches = dict(fa.LAUNCHES)
    eng = ServeEngine(_tiny_model(), image_size=32, buckets=BUCKETS,
                      device="cpu", telemetry=tel)
    batcher = ContinuousBatcher(eng, max_wait_s=0.001, telemetry=tel)
    sizes = [1, 3, 2, 5, 1, 4]
    reqs = [batcher.submit(_images(n, seed=n)) for n in sizes]
    outs = [r.wait(60) for r in reqs]
    batcher.close()
    tel.close(mode="serve")
    assert [o.shape for o in outs] == [(n, 10) for n in sizes]
    assert fa.LAUNCHES == launches          # the CPU never launches a kernel

    evs = [json.loads(ln) for ln in open(tmp_path / "events.0.jsonl")]
    for ev in evs:
        telemetry_lib.validate_event(ev)
    compiles = [e for e in evs if e["type"] == "compile"]
    assert sorted(e["bucket"] for e in compiles) == list(BUCKETS)
    assert all(e["phase"] == "serve_aot" for e in compiles)
    sb = [e for e in evs if e["type"] == "serve_batch"]
    assert sb and all(0 < e["n_valid"] <= e["bucket"] for e in sb)
    assert sum(e["n_valid"] for e in sb) == sum(sizes)

    from tpudist.summarize import analyze, load_events
    a = analyze(load_events(str(tmp_path), strict=True))
    sv = a["serving"]
    assert sv["n_requests"] == len(sizes)
    assert sv["aot_compiles"] == len(BUCKETS)
    assert sv["non_aot_compiles"] == 0
    assert sv["latency_p99_ms"] > 0
    assert a["run_end"]["productive_s"] > 0


def test_cli_serves_vit_b_32_on_cpu(tmp_path, capsys):
    rc = serve_cli.main(["--device", "cpu", "-a", "vit_b_32",
                         "--image-size", "64", "--buckets", "1,2",
                         "--load-rate", "10", "--load-duration", "0.3",
                         "--telemetry", "--outpath", str(tmp_path)])
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SERVE_SUMMARY ")]
    summary = json.loads(line[-1].split(" ", 1)[1])
    assert summary["arch"] == "vit_b_32" and summary["buckets"] == [1, 2]
    assert summary["n_requests"] >= 1 and summary["n_errors"] == 0
    evs = [json.loads(ln) for ln in open(tmp_path / "events.0.jsonl")]
    assert evs[0]["type"] == "run_start" and evs[0]["platform"] == "cpu"
    assert evs[-1]["type"] == "run_end"


@pytest.mark.parametrize("flag,missing", [
    (["--flash", "auto"], "attention dispatch"),
    (["--compile-cache", "/tmp/cc"], "compile cache"),
    (["--metrics-port", "0"], "metrics endpoint"),
    (["--checkpoint", "run/checkpoint.msgpack"], "msgpack"),
])
def test_cli_refuses_what_the_port_lacks(flag, missing, capsys):
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--device", "cpu", *flag])
    assert e.value.code != 0
    assert missing in capsys.readouterr().err
