"""Host tier: key interning and the decision engine."""
