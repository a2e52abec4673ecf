"""Messages of ``agentfield.model.v1.ModelNode/Generate`` (modelnode.proto).
``optional`` keeps field presence, so an unset sampling knob keeps the
server's default (proto3's zero value would turn an unset ``top_p`` into
0)."""

from __future__ import annotations

from agentfield_tpu_torch.control_plane.proto.wire import Field, Message


class GenerateRequest(Message):
    FULL_NAME = "agentfield.model.v1.GenerateRequest"
    FIELDS = (
        Field("prompt", 1, "string", optional=True),
        Field("tokens", 2, "int32", repeated=True),
        Field("max_new_tokens", 3, "int32", optional=True),
        Field("temperature", 4, "float", optional=True),
        Field("top_k", 5, "int32", optional=True),
        Field("top_p", 6, "float", optional=True),
        Field("stop_token_ids", 7, "int32", repeated=True),
        Field("session_id", 8, "string", optional=True),
        Field("response_schema_json", 9, "string", optional=True),  # JSON-encoded schema
        Field("context_overflow", 10, "string", optional=True),
        Field("images", 11, "bytes", repeated=True),  # raw encoded image bytes (PNG/JPEG)
    )


class GenerateResponse(Message):
    FULL_NAME = "agentfield.model.v1.GenerateResponse"
    FIELDS = (
        Field("tokens", 1, "int32", repeated=True),
        Field("text", 2, "string"),
        Field("finish_reason", 3, "string"),
        Field("model", 4, "string"),
        Field("logprobs", 5, "float", repeated=True),
        Field("truncated_prompt_tokens", 6, "int32"),
    )
