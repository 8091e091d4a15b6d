"""Serving: the dynamic batching queue over one searcher (`serve.DynamicBatcher`)."""
