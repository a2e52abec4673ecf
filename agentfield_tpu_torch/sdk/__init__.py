"""The node side of the control-plane protocol (counterpart of
``agentfield_tpu.sdk``): a stdlib HTTP client for registration, heartbeats
and execution status callbacks. Import the submodules directly."""
