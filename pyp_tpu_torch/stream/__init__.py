"""The web platform's RPC client."""
