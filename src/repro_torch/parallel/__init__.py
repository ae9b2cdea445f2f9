"""Sharding rules and DTensor placement of the port."""
