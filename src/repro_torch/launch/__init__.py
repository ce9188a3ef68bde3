"""Launchers: the mining, rule-serving, streaming and report CLIs, their
shared flags (``cliopts``) and the mining mesh (``mesh``)."""

from .mesh import (MiningMesh, init_distributed, make_local_mesh,
                   make_mining_mesh, shutdown_distributed)

__all__ = ["MiningMesh", "init_distributed", "make_local_mesh",
           "make_mining_mesh", "shutdown_distributed"]
