"""Messages of ``admin.v1.AdminReasonerService`` (admin.proto, package
``admin.v1``): ``ListReasoners`` is the reference's admin surface
(reasoner_admin.proto), ``ListNodes`` an additive extension."""

from __future__ import annotations

from agentfield_tpu_torch.control_plane.proto.wire import Field, Message


class ListReasonersRequest(Message):
    FULL_NAME = "admin.v1.ListReasonersRequest"
    FIELDS = ()


class Reasoner(Message):
    FULL_NAME = "admin.v1.Reasoner"
    FIELDS = (
        Field("reasoner_id", 1, "string"),
        Field("agent_node_id", 2, "string"),
        Field("name", 3, "string"),
        Field("description", 4, "string"),
        Field("status", 5, "string"),
        Field("node_version", 6, "string"),
        Field("last_heartbeat", 7, "string"),
    )


class ListReasonersResponse(Message):
    FULL_NAME = "admin.v1.ListReasonersResponse"
    FIELDS = (Field("reasoners", 1, Reasoner, repeated=True),)


class ListNodesRequest(Message):
    FULL_NAME = "admin.v1.ListNodesRequest"
    FIELDS = ()


class Node(Message):
    FULL_NAME = "admin.v1.Node"
    FIELDS = (
        Field("node_id", 1, "string"),
        Field("kind", 2, "string"),
        Field("status", 3, "string"),
        Field("base_url", 4, "string"),
        Field("did", 5, "string"),
        Field("last_heartbeat", 6, "double"),
        Field("reasoner_count", 7, "int32"),
        Field("skill_count", 8, "int32"),
    )


class ListNodesResponse(Message):
    FULL_NAME = "admin.v1.ListNodesResponse"
    FIELDS = (Field("nodes", 1, Node, repeated=True),)
