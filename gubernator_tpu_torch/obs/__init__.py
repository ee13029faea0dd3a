"""Observability planes of one node (the port's copy of the local half
of gubernator_tpu/obs): `obs.fleet.FleetCollector`, the rollup of this
node's counters, gauges and histograms, and `obs.slo`, the SLO watchdog
and the admission-bound watch that read it.  The peer fan-out and
/debug/fleet come with the peer planes."""
