"""Paper application configurations (mirrors ``repro.configs``)."""
