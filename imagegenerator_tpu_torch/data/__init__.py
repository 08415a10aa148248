"""Host-side data helpers: caption tokenizers."""
