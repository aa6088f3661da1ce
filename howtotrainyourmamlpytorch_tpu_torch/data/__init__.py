"""Episode sampling and the flat uint8 store behind the uint8 and index
ingests (numpy only: no tensor is made here)."""
