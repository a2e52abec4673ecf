"""The agent-developer SDK of the port (counterpart of ``agentfield_tpu.sdk``):
``Agent`` and its decorators, ``call``/``ai`` through the control plane,
on the standard library (``control_plane/http.py``). The model node's
blocking control-plane client is ``sdk/node_client.py``."""

from agentfield_tpu_torch.sdk.agent import Agent, AgentRouter, AIConfig  # noqa: F401
from agentfield_tpu_torch.sdk.context import ExecutionContext  # noqa: F401
from agentfield_tpu_torch.sdk.client import ControlPlaneClient  # noqa: F401
from agentfield_tpu_torch.sdk.multimodal import (  # noqa: F401
    AudioContent,
    FileContent,
    ImageContent,
    TextContent,
    UnsupportedModalityError,
)
