"""Parameter specs on one device (the single-device part of
``repro.dist``; meshes and collectives wait for the ``dist/`` slice)."""
