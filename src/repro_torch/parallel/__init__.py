"""Multi-device execution (counterpart of ``repro/parallel``): the
``(data, model)`` mesh of places, the logical-axis sharding rules and the
collectives the sharded server step and MoE block need
(``parallel/sharding.py``)."""
