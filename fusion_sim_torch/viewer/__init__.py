"""HTTP viewer serving live simulation frames + the JSON scene/state API."""
