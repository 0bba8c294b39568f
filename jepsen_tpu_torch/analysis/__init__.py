"""Host-side history analysis: the pre-search gate."""
