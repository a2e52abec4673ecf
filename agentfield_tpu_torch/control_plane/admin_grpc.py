"""Admin gRPC service: the port's copy of
``agentfield_tpu/control_plane/admin_grpc.py``, on the port's own transport
(``grpc_h2.py``) and hand-written messages (``proto/admin_pb2.py``) in
place of grpcio and protoc's.

Wire-compatible with the reference's admin surface (proto/admin/
reasoner_admin.proto `admin.v1.AdminReasonerService/ListReasoners`, served
on port+100 — internal/server/server.go:320-372): a client built against
the reference .proto, grpcio's included, interops unchanged. ``ListNodes``
is an additive extension.
"""

from __future__ import annotations

from agentfield_tpu_torch.control_plane import grpc_h2 as grpc
from agentfield_tpu_torch.control_plane.proto import admin_pb2

SERVICE = "admin.v1.AdminReasonerService"


class AdminService:
    def __init__(self, storage):
        self.storage = storage

    def service(self, handler_call_details):
        method = handler_call_details.method
        if method == f"/{SERVICE}/ListReasoners":
            return grpc.unary_unary_rpc_method_handler(
                self._list_reasoners,
                request_deserializer=admin_pb2.ListReasonersRequest.FromString,
                response_serializer=admin_pb2.ListReasonersResponse.SerializeToString,
            )
        if method == f"/{SERVICE}/ListNodes":
            return grpc.unary_unary_rpc_method_handler(
                self._list_nodes,
                request_deserializer=admin_pb2.ListNodesRequest.FromString,
                response_serializer=admin_pb2.ListNodesResponse.SerializeToString,
            )
        return None

    def _list_reasoners(self, request, context):
        resp = admin_pb2.ListReasonersResponse()
        for node in self.storage.list_nodes():
            for r in node.reasoners:
                resp.reasoners.add(
                    reasoner_id=r.id,
                    agent_node_id=node.node_id,
                    name=r.id,
                    description=r.description or "",
                    status=node.status.value,
                    node_version=str(node.metadata.get("version", "")),
                    last_heartbeat=str(node.last_heartbeat),
                )
        return resp

    def _list_nodes(self, request, context):
        resp = admin_pb2.ListNodesResponse()
        for n in self.storage.list_nodes():
            resp.nodes.add(
                node_id=n.node_id,
                kind=n.kind,
                status=n.status.value,
                base_url=n.base_url,
                did=n.did or "",
                last_heartbeat=n.last_heartbeat,
                reasoner_count=len(n.reasoners),
                skill_count=len(n.skills),
            )
        return resp


def start_admin_grpc(storage, port: int) -> grpc.Server:
    """Serve on `port` (callers use control-plane port + 100, as the
    reference does). A port that cannot be bound raises OSError."""
    server = grpc.server(max_workers=4)
    server.add_generic_rpc_handlers((AdminService(storage),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    if bound == 0:
        raise OSError(f"admin gRPC could not bind 127.0.0.1:{port} (port in use?)")
    server.start()
    return server


def admin_client_call(port: int, method: str, request=None):
    """Typed proto client for the admin service. Returns the decoded
    response message."""
    req_cls = getattr(admin_pb2, f"{method}Request")
    resp_cls = getattr(admin_pb2, f"{method}Response")
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        fn = channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString,
        )
        return fn(request or req_cls(), timeout=10)
