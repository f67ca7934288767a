"""Distribution: the sharding plan and the collectives' cost models."""
