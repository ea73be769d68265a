"""Transient cooling twin (CDU + tower loop), batched over scenarios."""
