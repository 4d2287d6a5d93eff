"""Spin-lattice MD: lattice, state, neighbor tables, integrator, engine."""
