"""The language-model substrate of the port (serving: prefill + decode)."""
