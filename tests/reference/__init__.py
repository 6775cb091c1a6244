"""Plain references that the tests hold the codec to."""
