"""The coordination store: engine, wire, client and server."""
