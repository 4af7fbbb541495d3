"""The port's HTTP front (``rcu_tpu_torch.serve.make_http_server``) beside
``rcu_tpu.serve``'s: the npz round trip, concurrent requests equal to
serial ones, ``/v1/health`` with the JAX keys, the 400s, 404s and the 500,
the ``Server-Timing`` header; and the serve CLI (its flags a superset of
``bin/serve.py``'s, ``-prewarm`` and its refusal with ``-quantize``,
``-devices``/``-throughput`` on the virtual CPU mesh)."""
import ast
import concurrent.futures
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rcu_tpu.serve import make_http_server as jax_http_server
from rcu_tpu_torch import serve
from rcu_tpu_torch.cli import serve as serve_cli
from tests.test_torch_serve import (env, jax_service,  # noqa: F401
                                    port_service)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", thread


@pytest.fixture(scope="module")
def servers(env):  # noqa: F811
    """{"port": (url, service), "jax": (url, service)}: a deterministic
    service of each package behind its HTTP front on an ephemeral port."""
    out, running = {}, []
    for name, make, http in (("port", port_service, serve.make_http_server),
                             ("jax", jax_service, jax_http_server)):
        service = make(env["model_dir"], mc=0)
        httpd = http(service, "127.0.0.1", 0)
        url, thread = start(httpd)
        running.append((httpd, thread))
        out[name] = (url, service)
    yield out
    for httpd, thread in running:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def npz(**arrays):
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def post(url, body, path="/v1/predict"):
    """-> (status, headers, body bytes); HTTP errors come back too."""
    req = urllib.request.Request(url + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers, err.read()


def get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def arrays(body):
    with np.load(io.BytesIO(body)) as out:
        return {k: out[k] for k in out.files}


def test_round_trip_equals_predict(env, servers):  # noqa: F811
    """A scored request over HTTP gives ``predict``'s arrays bitwise, with
    the timing of its decode, device work and encode in the header."""
    url, service = servers["port"]
    images, labels = env["subjects"]["s02"]
    status, headers, body = post(url, npz(images=images, target=labels))
    assert status == 200
    assert headers["Content-Type"] == "application/octet-stream"
    got, want = arrays(body), service.predict(images, target=labels)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert got[key].dtype == np.asarray(value).dtype, key
    timing = dict(part.strip().split(";dur=") for part in
                  headers["Server-Timing"].split(","))
    assert set(timing) == {"decode", "device", "encode"}
    assert all(float(ms) >= 0.0 for ms in timing.values())


def test_concurrent_requests_equal_serial_ones(env, servers):  # noqa: F811
    """4 client threads, 2 requests each, health probes among them: every
    answer equals the serial ``predict`` of its volume."""
    url, service = servers["port"]
    images, labels = env["subjects"]["s03"]
    rng = np.random.RandomState(11)
    volumes = [images + np.float32(0.1) * rng.rand(*images.shape)
               .astype(np.float32) for _ in range(8)]
    want = [service.predict(v, target=labels) for v in volumes]

    def client(k):
        out = []
        for v in volumes[2 * k:2 * k + 2]:
            status, _, body = post(url, npz(images=v, target=labels))
            assert status == 200
            assert get(url, "/v1/health")[0] == 200
            out.append(arrays(body))
        return out

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        got = [r for rs in pool.map(client, range(4)) for r in rs]
    for g, w in zip(got, want):
        for key, value in w.items():
            np.testing.assert_array_equal(g[key], value, err_msg=key)


def test_health_has_the_jax_keys(servers):
    got = {name: json.loads(get(url, "/v1/health")[1])
           for name, (url, _) in servers.items()}
    assert set(got["port"]) == set(got["jax"])
    for key in ("status", "model_dir", "strategy", "mc", "members",
                "batch_size"):
        assert got["port"][key] == got["jax"][key], key
    assert isinstance(got["port"]["compiled_shapes"], list)


@pytest.mark.parametrize("case", ["corrupt", "no images", "bad shape",
                                  "one sigma bound", "not npz"])
def test_client_faults_are_400_as_in_jax(servers, case):
    images = np.zeros((2, 16, 20, 4), np.float32)
    body = {"corrupt": b"PK\x03\x04 not a real zip",
            "no images": npz(wrong=np.zeros(3)),
            "bad shape": npz(images=images, target=np.zeros((2, 4, 4))),
            "one sigma bound": npz(images=images, sigma_min=np.float32(0)),
            "not npz": b"plain text"}[case]
    got = {name: post(url, body) for name, (url, _) in servers.items()}
    assert got["port"][0] == got["jax"][0] == 400
    assert got["port"][1]["Content-Type"] == "application/json"
    assert json.loads(got["port"][2]) == json.loads(got["jax"][2])


def test_unknown_paths_are_404(servers):
    for url, _ in servers.values():
        assert get(url, "/v1/nothing")[0] == 404
        assert post(url, npz(images=np.zeros(1)), "/v2/predict")[0] == 404


def test_server_faults_are_500(env, servers, monkeypatch):  # noqa: F811
    url, service = servers["port"]

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(service, "predict_timed", broken)
    status, headers, body = post(url, npz(images=env["subjects"]["s02"][0]))
    assert status == 500
    assert json.loads(body) == {"error": "CUDA out of memory"}


def flags_of(tree):
    """The option strings of every ``add_argument`` call in ``tree``."""
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"}


def test_cli_flags_are_a_superset_of_bin_serve():
    with open(os.path.join(REPO_ROOT, "bin", "serve.py")) as f:
        jax_flags = flags_of(ast.parse(f.read()))
    port_flags = {a.option_strings[0]
                  for a in serve_cli.build_parser()._actions[1:]}
    assert jax_flags and jax_flags <= port_flags
    assert port_flags - jax_flags == {"-device"}


def test_cli_prewarms_and_serves(env, monkeypatch):  # noqa: F811
    served = {}

    class Server:
        def __init__(self, service, host, port):
            served.update(service=service, address=(host, port))

        def serve_forever(self):
            served["forever"] = True

        def server_close(self):
            served["closed"] = True

    monkeypatch.setattr(serve, "make_http_server", Server)
    serve_cli.cli(["-model_dir", env["model_dir"], "-mc", "0",
                   "-batch_size", "2", "-prewarm", "3x16x20,1x16x20",
                   "-port", "0", "-device", "cpu"])
    assert served["forever"] and served["closed"]
    assert served["address"] == ("0.0.0.0", 0)
    assert served["service"].compiled_shapes() == ["1-slices-b1",
                                                   "4-slices-b2"]


def test_cli_refuses_prewarm_with_quantize(env, monkeypatch):  # noqa: F811
    """A quantized service calibrates int8 on its first request; a prewarm
    of zero volumes would calibrate it there, so the pair is refused before
    the service loads."""
    def refuse(*args, **kwargs):
        raise AssertionError("the service loaded")

    monkeypatch.setattr(serve, "VolumeInferenceService", refuse)
    with pytest.raises(ValueError, match="calibrate int8 on zero volumes"):
        serve_cli.cli(["-model_dir", env["model_dir"], "-mc", "0",
                       "-quantize", "-prewarm", "3x16x20", "-device", "cpu"])


class _Built(Exception):
    """Raised in place of binding the port: carries the built service."""


@pytest.mark.parametrize("argv,pool", [(["-devices", "2"], 1),
                                       (["-devices", "2", "-throughput"], 2)])
def test_cli_multi_device_flags_raise(env, argv, pool,  # noqa: F811
                                      monkeypatch):
    """``-devices 2 -device cpu`` serves on the virtual CPU mesh (latency
    mode; with ``-throughput`` a pool of two); ``-throughput`` without a
    mesh raises, and so does ``-devices 2`` on cuda with fewer cards."""
    def built(service, host, port):
        raise _Built(service)

    monkeypatch.setattr(serve, "make_http_server", built)
    base = ["-model_dir", env["model_dir"], "-mc", "0"]
    with pytest.raises(_Built) as got:
        serve_cli.cli(base + ["-device", "cpu"] + argv)
    service = got.value.args[0]
    assert service.pool_size == pool
    assert (service.mesh is None) == (pool == 2)
    with pytest.raises(ValueError, match="-throughput needs -devices"):
        serve_cli.cli(base + ["-device", "cpu", "-throughput"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="cuda device"):
            serve_cli.cli(base + argv)
