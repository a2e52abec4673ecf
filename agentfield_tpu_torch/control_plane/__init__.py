"""The control plane of the PyTorch/CUDA port: the port's copy of
``agentfield_tpu/control_plane`` (node registry, execution gateway, the
gateway's half of the node channel, SQLite or Postgres storage, webhooks,
health probes, the /api/v1 surface, the admin gRPC service) on asyncio and
the standard library, with ``http.py`` in place of aiohttp, ``pgwire.py``
in place of a Postgres driver and ``grpc_h2.py`` in place of grpcio. Model nodes are the port's
(``agentfield_tpu_torch.serving.model_node``); they register here as they
do with the JAX control plane.

    cp = ControlPlane()
    runner = await run_server(cp, "127.0.0.1", 8800)
    ...
    await runner.cleanup()
"""

from agentfield_tpu_torch.control_plane.server import ControlPlane, create_app, run_server  # noqa: F401
