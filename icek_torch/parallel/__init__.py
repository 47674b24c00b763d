"""Multi-process runtime (``distributed.py``) and the (data, model) device
mesh with its sharding rules and collectives (``mesh.py``)."""
