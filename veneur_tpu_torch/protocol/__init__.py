"""Wire-level helpers: listen-address resolution, the SSF schema and its
codec (``ssf.py``, no protobuf), and the framed-SSF stream (``wire.py``)."""
