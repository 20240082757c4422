"""Audio frontend of the port: wav IO, constant tables, log-mel / MFCC."""
