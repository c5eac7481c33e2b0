"""Sequence parallelism: device meshes, the scan correction, SP attention."""
