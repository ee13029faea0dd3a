"""Host-side helpers shared by the tiers (metrics)."""
