"""Serving: the LM engine with the kNN-LM head (`serve.Engine`, `serve.main`)
and the dynamic batching queue over one searcher (`serve.DynamicBatcher`)."""
