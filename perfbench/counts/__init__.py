"""The yardstick's FLOP and byte counts and the card's published peaks
(``peaks.json``). Nothing here calls the port."""
