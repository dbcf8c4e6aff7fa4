"""Single-card training of PixArt: the iDDPM loss, CAME, EMA and the trainer."""
