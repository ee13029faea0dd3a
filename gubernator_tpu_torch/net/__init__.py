"""The HTTP/JSON front."""
