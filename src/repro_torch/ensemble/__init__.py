"""The ensemble layer (port of ``repro.ensemble``): (T, B) schedules
(:mod:`.protocol`), the replica ensemble over the engine's Replicated plan
(:mod:`.replica`), parallel-tempering exchange (:mod:`.exchange`) and the
(T, B) phase-diagram sweep (:mod:`.sweep`)."""
