"""Hand-written protobuf messages of the control plane's and the model
node's gRPC services (``wire.py`` is the codec): the port's counterpart of
the JAX package's protoc-generated ``control_plane/proto/admin_pb2.py`` and
``modelnode_pb2.py``, with their names, fields and numbers, from
``agentfield_tpu/control_plane/proto/admin.proto`` and ``modelnode.proto``.
"""
