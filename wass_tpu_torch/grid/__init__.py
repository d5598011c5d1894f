"""The gridding stage (wassgridsurface): grid setup, per-frame gridding on the card, the gridded.nc cube."""
