"""Multi-process runs: the process group (``distributed``), the mesh of
data and model axes with its tensor-parallel rules (``mesh``), and the
differentiable collectives the models call (``collectives``)."""
