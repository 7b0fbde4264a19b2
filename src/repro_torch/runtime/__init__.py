"""The training runtime: checkpoint/restart, preemption, stragglers
(``repro.runtime`` counterparts)."""
