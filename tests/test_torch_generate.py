"""The port's generate app (``GenerateDeployment(device="cpu")``) against
the golden fixture and the JAX app (``apps/generate``, loaded by file).

The stream of ``generate_stream("the cell divides", 16)`` must equal
``greedy_tokens[:16]`` of ``tests/fixtures_golden_decoder.npz``,
``resume_from=k`` must yield exactly the suffix, unary ``generate`` must
equal the stream, and ``describe_engine()["engine"]["kv"]["sequences"]``
must drain to 0. Concurrent streams through both apps give the same
tokens.
"""

import asyncio
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import few_torch_threads  # noqa: F401
from bioengine_tpu_torch.apps.generate import service
from bioengine_tpu_torch.apps.generate.service import GenerateDeployment

REPO = Path(__file__).resolve().parent.parent
FIXTURE = Path(__file__).parent / "fixtures_golden_decoder.npz"
PROMPT = "the cell divides"


def _jax_app():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_deployment", REPO / "apps" / "generate" / "generate_deployment.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


async def _stream(app, prompt, n, **kwargs):
    return [item async for item in app.generate_stream(prompt, n, **kwargs)]


@pytest.mark.anyio
async def test_golden_stream_resume_unary_and_kv_drain():
    fx = dict(np.load(FIXTURE))
    app = GenerateDeployment(device="cpu")
    await app.async_init()
    try:
        await app.test_deployment()
        await app.check_health()
        items = await _stream(app, PROMPT, 16)
        tokens = [i["token"] for i in items]
        assert tokens == fx["greedy_tokens"][:16].tolist()
        assert [i["index"] for i in items] == list(range(16))
        assert "".join(i["text"] for i in items) == service.decode(tokens)
        resumed = await _stream(app, PROMPT, 16, resume_from=5)
        assert [i["token"] for i in resumed] == tokens[5:]
        assert [i["index"] for i in resumed] == list(range(5, 16))
        unary = await app.generate(PROMPT, max_new_tokens=16)
        assert unary == {"prompt": PROMPT, "tokens": tokens, "text": service.decode(tokens)}
        desc = await app.describe_engine()
        assert desc["engine"]["kv"]["sequences"] == 0
        assert desc["engine"]["device"] == "cpu" and desc["engine"]["mesh"] is None
        assert desc["loop"]["active"] == 0 and desc["loop"]["tokens"] >= 16 * 3
    finally:
        await app.close()


@pytest.mark.anyio
async def test_concurrent_streams_match_the_jax_app():
    """Three streams of different prompts and classes, submitted together,
    through each app: the same tokens, and the same describe keys."""
    jax_mod = _jax_app()
    assert service.encode("héllo") == jax_mod.encode("héllo")
    assert service.decode([104, 233, 300]) == jax_mod.decode([104, 233, 300])
    got = {}
    for name, app in (
        ("jax", jax_mod.GenerateDeployment(max_active=4)),
        ("port", GenerateDeployment(max_active=4, device="cpu")),
    ):
        await app.async_init()
        try:
            outs = await asyncio.gather(
                _stream(app, "a cell", 10),
                _stream(app, "mitochondria divide", 14, klass="bulk"),
                _stream(app, "x", 6, klass="background"),
            )
            desc = await app.describe_engine()
            got[name] = ([[i["token"] for i in o] for o in outs], desc)
        finally:
            await app.close()
    assert got["port"][0] == got["jax"][0]
    port_desc, jax_desc = got["port"][1], got["jax"][1]
    assert set(jax_desc["engine"]) <= set(port_desc["engine"])
    assert port_desc["engine"]["kv"] == jax_desc["engine"]["kv"]
    assert port_desc["loop"] == jax_desc["loop"]


@pytest.mark.anyio
async def test_health_before_init_and_multi_device_lease():
    """A multi-id lease without a mesh block is a dp mesh (``{"dp": -1}``,
    as ``generate_deployment.py`` resolves it), whose concurrent streams
    give the fixture's tokens; a tp axis is refused."""
    fx = dict(np.load(FIXTURE))
    app = GenerateDeployment(device="cpu")
    with pytest.raises(RuntimeError, match="not initialized"):
        await app.check_health()
    app.bioengine_device_ids = [0, 1, 2, 3]
    await app.async_init()
    try:
        assert app.engine.mesh_shape == {"dp": 4} and app.engine.chip_width == 4
        outs = await asyncio.gather(*(_stream(app, PROMPT, 16) for _ in range(3)))
        for items in outs:
            assert [i["token"] for i in items] == fx["greedy_tokens"][:16].tolist()
        desc = await app.describe_engine()
        assert desc["engine"]["mesh"] == {"dp": 4} and desc["engine"]["n_devices"] == 4
        assert desc["engine"]["kv"]["sequences"] == 0 and desc["engine"]["kv"]["blocks_in_use"] == 0
        assert len(app.engine.pools) == 4
    finally:
        await app.close()
    app = GenerateDeployment(device="cpu")
    app.bioengine_mesh_shard = {"axes": {"tp": -1}}
    with pytest.raises(ValueError, match="dp"):
        await app.async_init()
