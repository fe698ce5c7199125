"""AVEC data plane and destination side: memory, wire, transport, executor."""
